#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   four CUDA kernels of ``neuralvolumetricreconstructionformedicalimages_torch/csrc``;
2. calls each kernel at the main-path shapes (16 levels x 2^19 x 2 table,
   1024 rays x 192 samples of the chest phantom, bf16 rolled table, packed
   fracs, 4224 wrap-extension columns) and holds it against its plain
   PyTorch version on the same inputs: roll bit-equal; span atol 1e-5;
   bucket rtol/atol 1e-5 and bit-identical across two runs, also on 700
   identical points; unroll atol 1e-5;
3. times each kernel, its plain version and (where one PyTorch call
   computes the same function) that call with CUDA events, beside the
   least time the card could take (bytes over 3.35 TB/s, or f32
   operations over 67 TFLOP/s, whichever is larger);
4. trains ``configs/chest_phantom_r3.yaml`` for one epoch (50 steps of 1024
   rays x 192 samples) through the port's ``Trainer``, with its epoch-0
   eval, after setting every launch count to 0; fails unless each kernel
   launched at least 50 times and the loss is finite and falling;
5. prints the kernels as one JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero.  Without a CUDA device it
exits 1 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
_SOURCE = {"roll_broadcast_fm": "roll_kernels", "unroll_reduce_fm": "roll_kernels",
           "span_gather_sorted": "span_gather", "bucket_grad_matmul": "bucket_matmul"}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)

    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        gather_view_batch, load_dataset)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
    from neuralvolumetricreconstructionformedicalimages_torch.ops import bucket_matmul as bm
    from neuralvolumetricreconstructionformedicalimages_torch.ops import roll_kernels as rk
    from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        base_and_frac_t, corner_offsets)
    from neuralvolumetricreconstructionformedicalimages_torch.ops.sampling import (
        stratified_z_vals)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        Trainer, build_model, pin_fp32)
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        cuda_time_ms)

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}, torch {torch.__version__}, cuda {torch.version.cuda}")
    pin_fp32()
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, {len(_build.SOURCES)} "
          f"sources in parallel)")

    # ---- main-path inputs: one real training batch of the chest phantom ----
    cfg_path = "configs/chest_phantom_r3.yaml"
    cfg = load_config(cfg_path)
    gen = torch.Generator(device=dev).manual_seed(0)
    field = build_model(cfg, gen, dev)
    spec = field.encoder.grid
    L, S, C = spec.num_levels, spec.table_size, spec.level_dim
    D, K = spec.input_dim, 1 << spec.input_dim
    F, E = K * C, rk._PAD
    n_rays, n_samples = int(cfg["train"]["n_rays"]), int(cfg["render"]["n_samples"])
    dset = load_dataset(cfg["exp"]["datadir"], "train", n_rays, device=dev)
    batch = gather_view_batch(dset.arrays(), 0, n_rays, gen)
    rays = batch["rays"]
    z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], n_samples, True, gen)
    b = field.bound - 1e-6
    pts = torch.clamp(rays[:, None, :3] + rays[:, None, 3:6] * z[..., None], -b, b)
    x01 = torch.clamp((pts.reshape(-1, 3) + field.bound) / (2.0 * field.bound), 0, 1)
    B = x01.shape[0]
    table = torch.randn((L, S, C), generator=gen, device=dev)
    grads = torch.randn((L, C, B), generator=gen, device=dev)
    print(f"shapes: L={L} S={S} C={C} D={D} B={B} extend={E}")

    results = {}

    def record(kname, replaces, err, kernel, plain, library, n_bytes, n_ops):
        bms, by = bound_ms(n_bytes, n_ops)
        results[kname] = dict(
            name=kname, route="cuda",
            source=f"neuralvolumetricreconstructionformedicalimages_torch/csrc/"
                   f"{_SOURCE[kname]}.cu",
            replaces=replaces, launches=None, max_abs_err=float(err),
            ms=cuda_time_ms(kernel), plain_ms=cuda_time_ms(plain),
            library_ms=None if library is None else cuda_time_ms(library),
            bound_ms=bms, bound_by=by)
        r = results[kname]
        print(f"{kname}: max_abs_err {r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms  library "
              f"{'none' if r['library_ms'] is None else '%.4f ms' % r['library_ms']}  "
              f"bound {bms:.4f} ms ({by})")

    # ---- 1. roll_broadcast_fm: bit-equal ----
    R = rk.roll_broadcast_fm(table, spec, torch.bfloat16)
    R_plain = rk.roll_broadcast_fm_plain(table, spec, torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(R, R_plain):
        raise AssertionError("roll_broadcast_fm differs from its plain version")
    offs = torch.as_tensor(corner_offsets(spec), device=dev).long()
    idx = (torch.arange(S, device=dev)[None, None, :] + offs[:, :, None]) % S
    idx = idx.repeat_interleave(C, dim=1)                          # [L, K*C, S]
    src = table.transpose(1, 2).to(torch.bfloat16).repeat(1, K, 1).contiguous()
    record("roll_broadcast_fm", "neuralvolumetricreconstructionformedicalimages_tpu/"
           "ops/roll_kernels.py:152", (R.float() - R_plain.float()).abs().max(),
           lambda: rk.roll_broadcast_fm(table, spec, torch.bfloat16),
           lambda: rk.roll_broadcast_fm_plain(table, spec, torch.bfloat16),
           lambda: torch.gather(src, 2, idx),
           L * S * C * 4 + L * F * S * 2, 0)
    del idx, src, R_plain

    # ---- 2. span_gather_sorted (packed fracs, bf16 table): atol 1e-5 ----
    base_t, frac_t = base_and_frac_t(spec, x01)
    sk, perm = torch.sort(base_t, dim=-1, stable=True)
    spf = torch.gather(sg.pack_frac_t(frac_t), 1, perm)[:, None, :].contiguous()
    out = sg.span_gather_sorted(sk, spf, R, input_dim=D)
    out_plain = sg.span_gather_sorted_plain(sk, spf, R, input_dim=D)
    err = (out - out_plain).abs().max()
    if not err <= 1e-5:
        raise AssertionError(f"span_gather_sorted differs by {float(err)}")
    distinct = sum(int(torch.unique_consecutive(sk[l]).numel()) for l in range(L))
    record("span_gather_sorted", "neuralvolumetricreconstructionformedicalimages_tpu/"
           "ops/span_gather.py:282", err,
           lambda: sg.span_gather_sorted(sk, spf, R, input_dim=D),
           lambda: sg.span_gather_sorted_plain(sk, spf, R, input_dim=D), None,
           L * B * 4 * 2 + distinct * F * 2 + L * C * B * 4,
           L * B * (K * D + 2 * K * C))

    # ---- 3. bucket_grad_matmul: rtol/atol 1e-5, bit-identical twice ----
    sf = sg.unpack_frac_t(spf[:, 0])
    kw = dict(table_size=S, input_dim=D, extend_cols=E)
    g1 = bm.bucket_grad_matmul(sk, sf, grads, **kw)
    g2 = bm.bucket_grad_matmul(sk, sf, grads, **kw)
    g_plain = bm.bucket_grad_matmul_plain(sk, sf, grads, **kw)
    torch.cuda.synchronize()
    if not torch.equal(g1, g2):
        raise AssertionError("bucket_grad_matmul is not bit-identical across runs")
    torch.testing.assert_close(g1, g_plain, rtol=1e-5, atol=1e-5)
    err = (g1 - g_plain).abs().max()
    del g2, g_plain
    # duplicate-heavy: 700 identical points own one column
    dk = torch.full((L, 700), 12345, dtype=torch.int32, device=dev)
    df = torch.full((L, D, 700), 0.625, device=dev)
    dg = torch.randn((L, C, 700), generator=gen, device=dev)
    d1 = bm.bucket_grad_matmul(dk, df, dg, **kw)
    dplain = bm.bucket_grad_matmul_plain(dk, df, dg, **kw)
    torch.cuda.synchronize()
    if not torch.equal(d1, bm.bucket_grad_matmul(dk, df, dg, **kw)):
        raise AssertionError("bucket_grad_matmul (700 identical points) not reproducible")
    torch.testing.assert_close(d1, dplain, rtol=1e-5, atol=1e-5)
    dup_err = float((d1 - dplain).abs().max())
    dup_ms = cuda_time_ms(lambda: bm.bucket_grad_matmul(dk, df, dg, **kw))
    print(f"bucket_grad_matmul, 700 identical points: max_abs_err {dup_err:.3g}, "
          f"kernel {dup_ms:.4f} ms")
    del d1, dplain
    pay = bm._payload(sf, grads).permute(0, 2, 1).reshape(L * B, F)
    flat_keys = (sk.long() + torch.arange(L, device=dev)[:, None] * S).reshape(-1)
    record("bucket_grad_matmul", "neuralvolumetricreconstructionformedicalimages_tpu/"
           "ops/bucket_matmul.py:261", err,
           lambda: bm.bucket_grad_matmul(sk, sf, grads, **kw),
           lambda: bm.bucket_grad_matmul_plain(sk, sf, grads, **kw),
           lambda: torch.zeros((L * S, F), device=dev).index_add_(0, flat_keys, pay),
           L * B * 4 * (1 + D + C) + L * F * (S + E) * 4,
           L * B * (K * D + 2 * K * C))
    results["bucket_grad_matmul"]["duplicate_heavy"] = dict(
        points=700, max_abs_err=dup_err, ms=dup_ms)
    del pay, flat_keys

    # ---- 4. unroll_reduce_fm: atol 1e-5 ----
    u = rk.unroll_reduce_fm(g1, spec, C)
    u_plain = rk.unroll_reduce_fm_plain(g1, spec, C)
    err = (u - u_plain).abs().max()
    if not err <= 1e-5:
        raise AssertionError(f"unroll_reduce_fm differs by {float(err)}")
    record("unroll_reduce_fm", "neuralvolumetricreconstructionformedicalimages_tpu/"
           "ops/roll_kernels.py:192", err,
           lambda: rk.unroll_reduce_fm(g1, spec, C),
           lambda: rk.unroll_reduce_fm_plain(g1, spec, C), None,
           L * F * (S + E) * 4 + L * S * C * 4, L * S * C * (K - 1))
    del g1, u, u_plain, R, out, out_plain, table, grads, field, dset
    torch.cuda.empty_cache()

    # ---- 5. the training path: one epoch of chest_phantom_r3 ----
    cfg["train"]["epoch"] = 0      # one epoch: 50 views -> 50 steps
    cfg["log"]["i_save"] = 0       # no checkpoint
    cfg["log"]["i_eval"] = 1       # its epoch-0 eval
    trainer = Trainer(cfg, workdir=os.path.join("logs", "chip_smoke"), device="cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer.start()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = len(trainer.losses)
    print(f"training: {steps} steps in {wall:.1f} s wall (eval included), "
          f"launches {launches}")
    for kname, r in results.items():
        r["launches"] = int(launches.get(kname, 0))
        if r["launches"] < 50:
            raise AssertionError(f"{kname} launched {r['launches']} times on the "
                                 f"training path (need >= 50)")
    losses = trainer.losses
    if steps < 50 or not np.isfinite(losses).all():
        raise AssertionError(f"bad losses: {losses}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: first-10 mean {first}, "
                             f"last-10 mean {last}")
    step_ms = float(np.median(trainer.step_ms))
    ev = trainer.eval_metrics[0]
    print(f"loss: first-10 mean {first:.6g}, last-10 mean {last:.6g}")
    print(f"step: median {step_ms:.3f} ms, {n_rays / (step_ms / 1e3):.0f} rays/s "
          f"({n_rays} rays x {n_samples} samples per step)")
    print(f"eval (epoch 0): proj_psnr {ev['proj_psnr']:.3f} dB, "
          f"psnr_3d {ev['psnr_3d']:.3f} dB, ssim_3d {ev['ssim_3d']:.4f}")

    line = []
    for r in results.values():
        r["max_err"] = r["max_abs_err"]
        r["kernel_ms"] = r["ms"]
        line.append(r)
    print(json.dumps({"kernels": line, "train": {
        "config": cfg_path, "steps": steps, "median_step_ms": step_ms,
        "rays_per_s": n_rays / (step_ms / 1e3), "loss_first10": first,
        "loss_last10": last, "eval_epoch0": ev}, "card": smi}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
