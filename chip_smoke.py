#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   four CUDA kernels of ``neuralvolumetricreconstructionformedicalimages_torch/csrc``;
2. calls each kernel at the main-path shapes (16 levels x 2^19 x 2 table,
   1024 rays x 192 samples of the chest phantom, bf16 table dtype, packed
   fracs, 4224 wrap-extension columns) and holds it against its plain
   PyTorch version on the same inputs: roll bit-equal; span atol 1e-5 in
   both addressing modes (the rolled table, and the canonical table that
   the main path reads, ``span_gather_sorted[table]``), the two modes
   bit-equal (``torch.equal``) to each other; bucket bit-equal and
   bit-identical across two runs, also on 700 identical points; unroll
   atol 1e-5;
3. times each kernel, its plain version and (where one PyTorch call
   computes the same function) that call with ``utils/profiling.py::
   time_fn`` (CUDA events around each call; the median), beside the
   least time the card could take (bytes over 3.35 TB/s, or f32
   operations over 67 TFLOP/s, whichever is larger); the kernel and the
   library call also on the device (``utils/profiling.py::device_times``:
   ``torch.profiler`` sums of every kernel and memset of a call, and 200
   calls between one event pair), since the events around one call
   bracket the host's launch path too;
4. trains ``configs/chest_phantom_r3.yaml`` for one epoch (50 steps of 1024
   rays x 192 samples) through the port's ``Trainer``, with its epoch-0
   eval, after setting every launch count to 0; fails unless the span
   gather (table mode), the bucket and the unroll launched at least 50
   times, the roll build and the span gather's rolled mode not at all
   (the main path reads the canonical table; each mode has its own launch
   count), and the loss is finite and falling;
5. prints the kernels as one JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Phases of the other encoder paths, on the same inputs (before 4, while
the main-path inputs are alive, and after it):

a. the kernels in the modes the other paths run: the bucket with a bf16
   output (bit-equal: one rounding of the same f32 sums), the unroll on that bf16
   gradient (atol 1e-5), and the bucket at D=0 on the 1,572,864-long XOR
   stream of the same points (bit-equal, bit-identical twice);
b. ``scatter_level`` at N = 1,572,864, S = 2^19, C = 2: rtol/atol 1e-5 on
   normal payloads, bit-equal on integer ones and on a 700-update column;
   beside its event time, its device time and ``index_add_``'s;
c. the encoder microbenchmark (``scripts/microbench_encoder_torch.py``),
   every row, launch counts read around it;
d. 20 full-width training steps each of the XOR, rolled and take encoder
   paths through ``Trainer.train_step``, with the launches each requires
   (the roll build at least 20 times on the rolled path) and a finite,
   falling loss.

The bucket is the tile design of ``csrc/bucket_matmul.cu`` (one block per
1024-column tile with two searches per tile, slice blocks for runs of
2048 or more, every run summed in stream order) and is bit-equal to its
plain version in all three modes; the roll build is the column-pair
kernel of ``csrc/roll_kernels.cu`` (vector loads and stores); the span
gather's table mode reads each corner's channel pair of the canonical
table as one float2; ``scatter_level`` takes one update a thread.

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
           "span_gather_sorted": "span_gather", "bucket_grad_matmul": "bucket_matmul",
           "scatter_level": "scatter_level"}
_TPU = "neuralvolumetricreconstructionformedicalimages_tpu/"
_REPLACES = {"roll_broadcast_fm": _TPU + "ops/roll_kernels.py:152",
             "span_gather_sorted": _TPU + "ops/span_gather.py:282",
             "bucket_grad_matmul": _TPU + "ops/bucket_matmul.py:261",
             "unroll_reduce_fm": _TPU + "ops/roll_kernels.py:192",
             "scatter_level": "scripts/microbench_encoder.py:142"}
# The main path's kernels: launched in every step (True) or never (False).
MAIN_NEEDS = {"span_gather_sorted[table]": True, "bucket_grad_matmul": True,
              "unroll_reduce_fm": True, "span_gather_sorted": False,
              "roll_broadcast_fm": False}
# The other encoder paths of phase (d): overrides of the cfg's encoder and
# the kernels that must launch in every step (True) or never (False).
TRAIN_STEPS = 20
PATHS = {
    "xor": ({"hash_variant": "xor"},
            {"bucket_grad_matmul": True, "span_gather_sorted": False,
             "span_gather_sorted[table]": False, "unroll_reduce_fm": False,
             "roll_broadcast_fm": False}),
    "rolled": ({"forward": "rolled", "input_grads": True, "table_dtype": "bfloat16"},
               {"roll_broadcast_fm": True, "bucket_grad_matmul": True,
                "unroll_reduce_fm": True, "span_gather_sorted": False,
                "span_gather_sorted[table]": False}),
    "take": ({"backward": "take"},
             {k: False for k in (*_SOURCE, "span_gather_sorted[table]")}),
}


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
    from neuralvolumetricreconstructionformedicalimages_torch.ops import scatter_level as sl
    from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        base_and_frac_t, corner_offsets)
    from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (
        hash_grid_indices, sorted_corner_stream)
    from neuralvolumetricreconstructionformedicalimages_torch.ops.sampling import (
        stratified_z_vals)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        Trainer, build_model, pin_fp32)
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        StepTimer, device_times, time_fn)
    sys.path.insert(0, os.path.join(root, "scripts"))
    import microbench_encoder_torch as microbench

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

    def median_ms(fn, warmup=3, iters=20):
        return time_fn(fn, warmup=warmup, iters=iters)["median_s"] * 1e3

    def record(kname, err, kernel, plain, library, n_bytes, n_ops, mode=None,
               plain_iters=20):
        """Time a kernel, its plain version and the library call; keep the
        entry (or, with ``mode``, a sub-entry of the kernel's entry)."""
        bms, by = bound_ms(n_bytes, n_ops)
        kdev = device_times(kernel)
        ldev = None if library is None else device_times(library)
        entry = dict(
            name=kname if mode is None else f"{kname}[{mode}]", route="cuda",
            source=f"neuralvolumetricreconstructionformedicalimages_torch/csrc/"
                   f"{_SOURCE[kname]}.cu",
            replaces=_REPLACES[kname], launches=None, max_abs_err=float(err),
            ms=median_ms(kernel),
            plain_ms=median_ms(plain, warmup=min(3, plain_iters), iters=plain_iters),
            library_ms=None if library is None else median_ms(library),
            bound_ms=bms, bound_by=by,
            device_ms=kdev["back_to_back_ms"], device_profiler_ms=kdev["profiler_ms"],
            library_device_ms=None if ldev is None else ldev["back_to_back_ms"],
            library_device_profiler_ms=None if ldev is None else ldev["profiler_ms"])
        if mode is None:
            results[kname] = entry
        else:
            results[kname].setdefault("modes", {})[mode] = entry
        lib = entry["library_ms"]
        print(f"{entry['name']}: max_abs_err {entry['max_abs_err']:.3g}  kernel "
              f"{entry['ms']:.4f} ms  plain {entry['plain_ms']:.4f} ms  library "
              f"{'none' if lib is None else '%.4f ms' % lib}  "
              f"bound {bms:.4f} ms ({by})")
        for who, t in (("kernel", kdev), ("library", ldev)):
            if t is not None:
                parts = ", ".join(f"{k[:40]} {v:.4f}" for k, v in t["parts"].items())
                print(f"  {who} on the device: {t['back_to_back_ms']:.4f} ms a call "
                      f"back to back, profiler {t['profiler_ms']:.4f} ms ({parts})")
        return entry

    def entry_of(key):
        """The kernels-line entry of a launch count's key: ``name`` or
        ``name[mode]``."""
        kname, _, mode = key.rstrip("]").partition("[")
        return results[kname]["modes"][mode] if mode else results[kname]

    # ---- 1. roll_broadcast_fm (the column-pair kernel): bit-equal ----
    R = rk.roll_broadcast_fm(table, spec, torch.bfloat16)
    R_plain = rk.roll_broadcast_fm_plain(table, spec, torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(R, R_plain):
        raise AssertionError("roll_broadcast_fm differs from its plain version")
    offs = torch.as_tensor(corner_offsets(spec), device=dev).long()
    idx = (torch.arange(S, device=dev)[None, None, :] + offs[:, :, None]) % S
    idx = idx.repeat_interleave(C, dim=1)                          # [L, K*C, S]
    src = table.transpose(1, 2).to(torch.bfloat16).repeat(1, K, 1).contiguous()
    # bound of the column-pair kernel: the f32 table read once, the bf16
    # rolled table written once
    record("roll_broadcast_fm", (R.float() - R_plain.float()).abs().max(),
           lambda: rk.roll_broadcast_fm(table, spec, torch.bfloat16),
           lambda: rk.roll_broadcast_fm_plain(table, spec, torch.bfloat16),
           lambda: torch.gather(src, 2, idx),
           L * S * C * 4 + L * F * S * 2, 0)
    del idx, src, R_plain

    # ---- 2. span_gather_sorted (packed fracs, bf16 table), both modes:
    # atol 1e-5 against the plain version, the modes bit-equal ----
    base_t, frac_t = base_and_frac_t(spec, x01)
    sk, perm = torch.sort(base_t, dim=-1, stable=True)
    spf = torch.gather(sg.pack_frac_t(frac_t), 1, perm)[:, None, :].contiguous()
    out = sg.span_gather_sorted(sk, spf, R, input_dim=D)
    out_plain = sg.span_gather_sorted_plain(sk, spf, R, input_dim=D)
    err = (out - out_plain).abs().max()
    if not err <= 1e-5:
        raise AssertionError(f"span_gather_sorted differs by {float(err)}")
    distinct = sum(int(torch.unique_consecutive(sk[l]).numel()) for l in range(L))
    record("span_gather_sorted", err,
           lambda: sg.span_gather_sorted(sk, spf, R, input_dim=D),
           lambda: sg.span_gather_sorted_plain(sk, spf, R, input_dim=D), None,
           L * B * 4 * 2 + distinct * F * 2 + L * C * B * 4,
           L * B * (K * D + 2 * K * C))
    # table mode (the main path): the canonical f32 table at the corners'
    # offsets, rounded to bf16 as the roll rounds
    out_t = sg.span_gather_sorted_table(sk, spf, table, spec, torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(out_t, out):
        raise AssertionError("span_gather_sorted[table] is not bit-equal to the "
                             "rolled mode")
    err = (out_t - sg.span_gather_sorted_table_plain(
        sk, spf, table, spec, torch.bfloat16)).abs().max()
    if not err <= 1e-5:
        raise AssertionError(f"span_gather_sorted[table] differs by {float(err)}")
    # bound: keys, packed fracs and output, and the canonical rows that some
    # corner of some key touches, each read once.  Beside it, the 32-byte
    # sectors each mode must fetch at least once: of every rolled row, the
    # sectors that hold a key's column; of the canonical table, those that
    # hold a touched row.
    touched = sec_rolled = sec_table = 0
    for l in range(L):
        uk = torch.unique_consecutive(sk[l]).long()
        rows = torch.unique((uk[:, None] + offs[l][None, :]) % S)
        touched += int(rows.numel())
        sec_rolled += int(torch.unique_consecutive(uk // (32 // R.element_size())).numel())
        sec_table += int(torch.unique_consecutive(rows // (32 // (C * 4))).numel())
    sector_mb = {"rolled": sec_rolled * F * 32 / 1e6, "table": sec_table * 32 / 1e6}
    print(f"span_gather_sorted[table]: {distinct} distinct keys, {touched} "
          f"canonical rows touched (of {L * S}); 32-byte sectors to fetch: "
          f"rolled table {sector_mb['rolled']:.1f} MB ({F} rows), canonical "
          f"table {sector_mb['table']:.1f} MB, beside "
          f"{L * B * 4 * (2 + C) / 1e6:.1f} MB of keys, fracs and output")
    record("span_gather_sorted", err,
           lambda: sg.span_gather_sorted_table(sk, spf, table, spec, torch.bfloat16),
           lambda: sg.span_gather_sorted_table_plain(sk, spf, table, spec,
                                                     torch.bfloat16), None,
           L * B * 4 * 2 + touched * C * 4 + L * C * B * 4,
           L * B * (K * D + 2 * K * C), mode="table")
    del out_t

    # ---- 3. bucket_grad_matmul: bit-equal to plain, bit-identical twice ----
    sf = sg.unpack_frac_t(spf[:, 0])
    kw = dict(table_size=S, input_dim=D, extend_cols=E)
    g1 = bm.bucket_grad_matmul(sk, sf, grads, **kw)
    g2 = bm.bucket_grad_matmul(sk, sf, grads, **kw)
    g_plain = bm.bucket_grad_matmul_plain(sk, sf, grads, **kw)
    torch.cuda.synchronize()
    if not torch.equal(g1, g2):
        raise AssertionError("bucket_grad_matmul is not bit-identical across runs")
    err = (g1 - g_plain).abs().max()
    if not torch.equal(g1, g_plain):
        raise AssertionError(f"bucket_grad_matmul is not bit-equal to its plain "
                             f"version (max abs diff {float(err)})")
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
    dup_err = float((d1 - dplain).abs().max())
    if not torch.equal(d1, dplain):
        raise AssertionError(f"bucket_grad_matmul (700 identical points) is not "
                             f"bit-equal to its plain version ({dup_err})")
    dup_ms = median_ms(lambda: bm.bucket_grad_matmul(dk, df, dg, **kw))
    print(f"bucket_grad_matmul, 700 identical points: max_abs_err {dup_err:.3g}, "
          f"kernel {dup_ms:.4f} ms")
    del d1, dplain
    pay = bm._payload(sf, grads).permute(0, 2, 1).reshape(L * B, F)
    flat_keys = (sk.long() + torch.arange(L, device=dev)[:, None] * S).reshape(-1)
    # bound of the tile design: keys, fracs and grads read once, the
    # wrap-extended f32 gradient written once (empty columns as zeros)
    record("bucket_grad_matmul", err,
           lambda: bm.bucket_grad_matmul(sk, sf, grads, **kw),
           lambda: bm.bucket_grad_matmul_plain(sk, sf, grads, **kw),
           lambda: torch.zeros((L * S, F), device=dev).index_add_(0, flat_keys, pay),
           L * B * 4 * (1 + D + C) + L * F * (S + E) * 4,
           L * B * (K * D + 2 * K * C))
    results["bucket_grad_matmul"]["duplicate_heavy"] = dict(
        points=700, max_abs_err=dup_err, ms=dup_ms)

    # ---- 4. unroll_reduce_fm: atol 1e-5 ----
    u = rk.unroll_reduce_fm(g1, spec, C)
    u_plain = rk.unroll_reduce_fm_plain(g1, spec, C)
    err = (u - u_plain).abs().max()
    if not err <= 1e-5:
        raise AssertionError(f"unroll_reduce_fm differs by {float(err)}")
    record("unroll_reduce_fm", err,
           lambda: rk.unroll_reduce_fm(g1, spec, C),
           lambda: rk.unroll_reduce_fm_plain(g1, spec, C), None,
           L * F * S * 4 + L * S * C * 4, L * S * C * (K - 1))
    del g1, u, u_plain, R, out, out_plain

    # ---- a. the modes of the other encoder paths ----
    # bucket with a bf16 output (the rolled backward): both round the same
    # stream-order f32 sums once, to nearest, so they are bit-equal
    kwb = dict(kw, out_dtype=torch.bfloat16)
    h1 = bm.bucket_grad_matmul(sk, sf, grads, **kwb)
    h_plain = bm.bucket_grad_matmul_plain(sk, sf, grads, **kwb)
    torch.cuda.synchronize()
    if not torch.equal(h1, h_plain):
        err = float((h1.float() - h_plain.float()).abs().max())
        raise AssertionError(f"bucket_grad_matmul (bf16 output) is not bit-equal to "
                             f"its plain version (max abs diff {err})")
    # bound of the tile design: the same reads, half the bytes written
    record("bucket_grad_matmul", (h1.float() - h_plain.float()).abs().max(),
           lambda: bm.bucket_grad_matmul(sk, sf, grads, **kwb),
           lambda: bm.bucket_grad_matmul_plain(sk, sf, grads, **kwb),
           lambda: torch.zeros((L * S, F), device=dev).index_add_(0, flat_keys, pay),
           L * B * 4 * (1 + D + C) + L * F * (S + E) * 2,
           L * B * (K * D + 2 * K * C), mode="bf16_out", plain_iters=3)
    del h_plain, pay, flat_keys
    # unroll of that bf16 gradient: atol 1e-5
    u = rk.unroll_reduce_fm(h1, spec, C)
    err = (u - rk.unroll_reduce_fm_plain(h1, spec, C)).abs().max()
    if not err <= 1e-5:
        raise AssertionError(f"unroll_reduce_fm (bf16 input) differs by {float(err)}")
    record("unroll_reduce_fm", err,
           lambda: rk.unroll_reduce_fm(h1, spec, C),
           lambda: rk.unroll_reduce_fm_plain(h1, spec, C), None,
           L * F * S * 2 + L * S * C * 4, L * S * C * (K - 1), mode="bf16_in")
    del h1, u
    # bucket at D=0 on the XOR stream of the same points (the XOR backward)
    xidx, xw = hash_grid_indices(spec, x01)
    xsk, xsg = sorted_corner_stream(xidx, xw, grads.permute(2, 0, 1))
    del xidx, xw
    NX = xsk.shape[1]
    xsf = torch.empty((L, 0, NX), device=dev)
    kw0 = dict(table_size=S, input_dim=0)
    x1 = bm.bucket_grad_matmul(xsk, xsf, xsg, **kw0)
    x2 = bm.bucket_grad_matmul(xsk, xsf, xsg, **kw0)
    x_plain = bm.bucket_grad_matmul_plain(xsk, xsf, xsg, **kw0)
    torch.cuda.synchronize()
    if not torch.equal(x1, x2):
        raise AssertionError("bucket_grad_matmul (D=0) is not bit-identical across runs")
    xerr = (x1 - x_plain).abs().max()
    if not torch.equal(x1, x_plain):
        raise AssertionError(f"bucket_grad_matmul (D=0) is not bit-equal to its "
                             f"plain version (max abs diff {float(xerr)})")
    print(f"bucket_grad_matmul[xor_d0]: stream {L} x {NX}, bit-equal to plain")
    xflat = (xsk.long() + torch.arange(L, device=dev)[:, None] * S).reshape(-1)
    xpay = xsg.permute(0, 2, 1).reshape(L * NX, C)
    # bound of the tile design at D=0: the 8x longer stream (keys and
    # grads) read once, the f32 gradient without extension written once
    record("bucket_grad_matmul", xerr,
           lambda: bm.bucket_grad_matmul(xsk, xsf, xsg, **kw0),
           lambda: bm.bucket_grad_matmul_plain(xsk, xsf, xsg, **kw0),
           lambda: torch.zeros((L * S, C), device=dev).index_add_(0, xflat, xpay),
           L * NX * 4 * (1 + C) + L * C * S * 4, L * NX * C * 2,
           mode="xor_d0", plain_iters=2)
    del x1, x2, x_plain, xflat, xpay, xsk, xsg, xsf

    # ---- b. scatter_level at the microbenchmark's shape ----
    NS = B * K
    sidx = torch.randint(0, S, (NS,), generator=gen, device=dev, dtype=torch.int32)
    spay = torch.randn((NS, C), generator=gen, device=dev)
    s1 = sl.scatter_level(sidx, spay, S)
    s_plain = sl.scatter_level_plain(sidx, spay, S)
    torch.cuda.synchronize()
    torch.testing.assert_close(s1, s_plain, rtol=1e-5, atol=1e-5)
    ipay = torch.randint(-50, 50, (NS, C), generator=gen, device=dev).float()
    iidx = sidx.clone()
    iidx[:700] = 4321                              # one 700-update column
    if not torch.equal(sl.scatter_level(iidx, ipay, S),
                       sl.scatter_level_plain(iidx, ipay, S)):
        raise AssertionError("scatter_level differs on integer payloads")
    record("scatter_level", (s1 - s_plain).abs().max(),
           lambda: sl.scatter_level(sidx, spay, S),
           lambda: sl.scatter_level_plain(sidx, spay, S),
           lambda: torch.zeros((S, C), device=dev).index_add_(0, sidx.long(), spay),
           NS * (4 + 4 * C) + S * C * 4, NS * C)
    del s1, s_plain, sidx, spay, ipay, iidx, sk, perm, spf, sf, base_t, frac_t
    del table, grads, field, dset
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
    for kname, every_step in MAIN_NEEDS.items():
        n = int(launches.get(kname, 0))
        if (n < 50) if every_step else n:
            raise AssertionError(f"{kname} launched {n} times in the main path's "
                                 f"{steps} steps")
        entry_of(kname)["launches"] = n
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
    del trainer
    torch.cuda.empty_cache()

    # ---- c. the encoder microbenchmark (the path of scatter_level) ----
    _build.reset_launches()
    bench_rows = microbench.run(device=dev)
    torch.cuda.synchronize()
    results["scatter_level"]["launches"] = int(_build.LAUNCHES.get("scatter_level", 0))
    if results["scatter_level"]["launches"] < 1:
        raise AssertionError("the microbenchmark launched no scatter_level kernel")
    bad = [n for n, r in bench_rows.items()
           if not np.isfinite([r["ms"], r["checksum"]]).all()]
    if bad or set(bench_rows) != set(microbench.NAMES):
        raise AssertionError(f"microbenchmark rows missing or not finite: {bad}")
    torch.cuda.empty_cache()

    # ---- d. the XOR, rolled and take encoder paths, 20 steps each ----
    paths = {}
    for pname, (enc_over, need) in PATHS.items():
        pcfg = load_config(cfg_path)
        pcfg["encoder"].update(enc_over)
        pcfg["log"]["i_eval"] = 0      # no eval
        pcfg["log"]["i_save"] = 0      # no checkpoint
        tr = Trainer(pcfg, workdir=os.path.join("logs", f"chip_smoke_{pname}"),
                     device="cuda")
        views = tr._view_order(0)[:TRAIN_STEPS]
        torch.cuda.synchronize()
        _build.reset_launches()
        timer = StepTimer(dev)
        timer.tick()
        step_losses = []
        for v in views:
            step_losses.append(tr.train_step(v))
            timer.tick()
        plosses = torch.stack(step_losses).cpu().numpy()
        pms = timer.step_ms()
        plaunch = dict(_build.LAUNCHES)
        for kname, every_step in need.items():
            n = int(plaunch.get(kname, 0))
            if (n < TRAIN_STEPS) if every_step else n:
                raise AssertionError(f"{pname} path: {kname} launched {n} times "
                                     f"in {TRAIN_STEPS} steps")
        if not np.isfinite(plosses).all():
            raise AssertionError(f"{pname} path: bad losses {plosses}")
        pf, pl = float(plosses[:5].mean()), float(plosses[-5:].mean())
        if not pl < pf:
            raise AssertionError(f"{pname} path: loss did not fall: first-5 mean "
                                 f"{pf}, last-5 mean {pl}")
        pmed = float(np.median(pms))
        paths[pname] = dict(encoder=enc_over, steps=len(plosses), median_step_ms=pmed,
                            rays_per_s=n_rays / (pmed / 1e3), loss_first5=pf,
                            loss_last5=pl, launches=plaunch)
        print(f"path {pname}: {len(plosses)} steps, median {pmed:.3f} ms, "
              f"{n_rays / (pmed / 1e3):.0f} rays/s, loss first-5 {pf:.6g} "
              f"last-5 {pl:.6g}, launches {plaunch}")
        for kname, mode in (("bucket_grad_matmul", {"xor": "xor_d0", "rolled": "bf16_out"}),
                            ("unroll_reduce_fm", {"rolled": "bf16_in"})):
            if pname in mode:
                results[kname]["modes"][mode[pname]]["launches"] = \
                    int(plaunch.get(kname, 0))
        if pname == "rolled":   # the roll build's path since the main path skips it
            results["roll_broadcast_fm"]["launches"] = int(plaunch["roll_broadcast_fm"])
        del tr
        torch.cuda.empty_cache()

    line = []
    for r in results.values():
        for entry in (r, *r.get("modes", {}).values()):
            entry["max_err"] = entry["max_abs_err"]
            entry["kernel_ms"] = entry["ms"]
        line.append(r)
    print(json.dumps({"kernels": line, "train": {
        "config": cfg_path, "steps": steps, "median_step_ms": step_ms,
        "rays_per_s": n_rays / (step_ms / 1e3), "loss_first10": first,
        "loss_last10": last, "eval_epoch0": ev}, "paths": paths,
        "microbench": bench_rows, "card": smi}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
