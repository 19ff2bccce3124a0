#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   four CUDA kernels of ``neuralvolumetricreconstructionformedicalimages_torch/csrc``;
2. calls each kernel at the main-path shapes (16 levels x 2^19 x 2 table,
   1024 rays x 192 samples of the chest phantom, bf16 table dtype, packed
   fracs, 4224 wrap-extension columns) and holds it against its plain
   PyTorch version on the same inputs: roll bit-equal; span atol 1e-5 on
   the rolled table, and on the canonical table that the main path reads
   (``span_gather_sorted[table]``) bit-equal (``torch.equal``) to its
   plain version and to the rolled mode; bucket bit-equal and
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
   eval, after setting every launch count to 0.  ``Trainer.start`` runs
   the epoch function: one eager step, one capture of the step as a CUDA
   graph, 49 replays.  Fails unless the span gather (table mode), the
   bucket and the unroll launched exactly 50 times, by the replay-aware
   launch counts and by a ``torch.profiler`` trace of the epoch (the
   kernels that ran), the roll build and the span gather's rolled mode
   not at all (the main path reads the canonical table; each mode has its
   own launch count), and the loss is finite and falling.  Then a second
   trainer from the same seed takes the same 50 steps through the eager
   ``Trainer.train_step`` loop: its losses must be ``torch.equal`` to the
   graphed epoch's.  5 more replayed steps run under
   ``torch.cuda.set_sync_debug_mode("error")`` (0 host syncs a replayed
   step, or the phase fails), and one more epoch of each, timed by events
   and one traced, gives the graphed and the eager median step, device ms
   a step, idle share and peak memory;
5. prints the data side's results and the kernels, one JSON line each,
   then, as the last line, ``{"ok": true, "device": {...}}``.

Phases of the other encoder paths, on the same inputs (before 4, while
the main-path inputs are alive, and after it), and of the data side
(after 4, before c):

a. the kernels in the modes the other paths run: the bucket with a bf16
   output (bit-equal: one rounding of the same f32 sums), the unroll on that bf16
   gradient (atol 1e-5), and the bucket at D=0 on the 1,572,864-long XOR
   stream of the same points (bit-equal, bit-identical twice);
b. ``scatter_level`` at N = 1,572,864, S = 2^19, C = 2: rtol/atol 1e-5 on
   normal payloads, bit-equal on integer ones and on a 700-update column;
   beside its event time, its device time and ``index_add_``'s;
c. the encoder microbenchmark (``scripts/microbench_encoder_torch.py``),
   every row, launch counts read around it;
d. 20 full-width training steps each of the XOR, rolled (with input
   gradients) and take encoder paths through ``Trainer.train_steps`` (the
   graphed epoch function), with the launches each requires (each
   kernel of the path exactly once a step, the others never), by the
   replay-aware counts and by a profiler trace of the steps, and a
   finite, falling loss;
e. the data side on the card, each path driven with the launch counts
   set to 0 just before it and read just after:
   e1. the projector (``data/projector.py::project_angles``) reprojects
       the 50 train views of ``data/chest_phantom.pickle`` (made by an
       earlier JAX projector): every pixel within 1e-6 of the stored
       projections but at most 24, all in views 16 and 34, where today's
       JAX projector misses them too (a sample within an ulp of the
       in-volume band's edge), and those within one boundary-voxel sample;
   e2. ``data/generate.py`` makes the laminography scan of
       ``configs/scans/lamino_chip.yaml`` on the card (``lamino_chip``
       phantom, 128 x 128 x 32, parallel beam tilted 29 degrees over 360,
       50 + 50 views) and
       ``configs/lamino_chip.yaml`` trains one epoch on it (50 steps of
       1024 rays x 192 samples, full width) with its epoch-0 eval;
   e3. the real-scan path: the 187 angles of ``data/angles_real.npy``,
       a smoothed chip phantom (256 x 256 x 64) projected on the card at
       1024^2 x 320 samples, a unit-amplitude complex field through
       ``data/format_real.py``, beam masks and pools from the C++ host
       engine (``native/``, timed inside the dataset build),
       ``configs/chest_50.yaml`` at 4096 rays with rays on the fly, 20
       masked steps through the graphed epoch function and one masked
       eval; then the span gather's table
       mode, the bucket and the unroll held against their plain versions
       as in 2-4 and timed on one 4096-ray batch of that path (786,432
       sorted points a level), under the modes ``table_real_scan`` and
       ``real_scan`` of the kernels line;
   each training path must launch the span gather's table mode, the
   bucket and the unroll exactly once a step and the roll build and the
   rolled mode never, by the replay-aware counts and by a profiler trace
   of its steps, with a finite, falling loss;
f. the parallel layer (``parallel/``) on the card, after e:
   f1. ``configs/chest_phantom_r3.yaml`` with ``parallel: {mesh: {data: 1,
       sample: 1}, force_mesh: true}``: the trainer makes a one-rank NCCL
       group and trains one epoch (50 steps at full width) through the
       sharded step; its 50 losses ``torch.equal`` to phase 4's;
   f2. data=2: two ranks that share cuda:0 under gloo (NCCL refuses two
       ranks on one device), chest_phantom_r3 at 1024 global rays (512 a
       rank), 20 steps; then one fed batch of 1024 rays split in two
       against the single-process step on the whole batch: the loss to
       rtol 1e-6, every gradient tensor within 1e-4 of its largest entry;
   f3. data=1 x sample=2 on the same two ranks, 96 samples each: with
       ``perturb`` off one step's loss against the single-process step's
       (rtol 1e-5; gradients as in f2), then 20 steps with ``perturb`` on;
   each rank must launch the three main-path kernels in every step, hold
   the same parameters as the other (a checksum) and read a finite,
   falling loss.  Gloo stages every all-reduce through the host, so f2's
   and f3's times are not those of NCCL across cards.

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
# Phase (f): the two shared-card ranks' group times out after this; the
# parent kills them after PARALLEL_JOIN_S.
PARALLEL_GROUP_TIMEOUT_S, PARALLEL_JOIN_S = 120, 300
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


# Phase (e): the scan of the dataset configs/lamino_chip.yaml trains on,
# and the real-scan path's size.
LAMINO_SCAN = "configs/scans/lamino_chip.yaml"
REAL_VIEWS, REAL_DET, REAL_SAMPLES, REAL_RAYS = 187, 1024, 320, 4096
# e1: the stored chest views that today's JAX projector misses, and at how
# many pixels in all
E1_VIEWS_OFF, E1_PIXELS_OFF = {16, 34}, 24
# e3: the kernels-line entries of the main path's kernels at the real-scan
# shapes, by launch count key
REAL_MODES = {"span_gather_sorted[table]": "span_gather_sorted[table_real_scan]",
              "bucket_grad_matmul": "bucket_grad_matmul[real_scan]",
              "unroll_reduce_fm": "unroll_reduce_fm[real_scan]"}


def check_launches(where: str, launches, steps: int, needs=MAIN_NEEDS) -> None:
    """Fail unless each kernel that ``needs`` marks True launched at least
    once a step in ``steps`` steps, and each marked False never."""
    for kname, every_step in needs.items():
        n = int(launches.get(kname, 0))
        if (n < steps) if every_step else n:
            raise AssertionError(f"{where}: {kname} launched {n} times in "
                                 f"{steps} steps")


def check_exact(where: str, launches, steps: int, needs=MAIN_NEEDS) -> None:
    """Fail unless each kernel that ``needs`` marks True launched exactly
    once a step in ``steps`` steps, and each marked False never."""
    for kname, every_step in needs.items():
        n = int(launches.get(kname, 0))
        if n != (steps if every_step else 0):
            raise AssertionError(f"{where}: {kname} launched {n} times in "
                                 f"{steps} steps")


def _launch_key(kernel: str):
    """The launch-count key of a kernel of ``csrc/`` by its traced name
    (the span gather's mode is its last template argument, 0 = rolled),
    or None for any other kernel."""
    import re

    if "span_gather_kernel<" in kernel:
        mode = re.search(r"span_gather_kernel<([^>]*)>", kernel).group(1).split(",")[-1]
        return "span_gather_sorted" if mode.strip() == "0" else "span_gather_sorted[table]"
    for name, key in (("bucket_kernel<", "bucket_grad_matmul"),
                      ("unroll_reduce_kernel<", "unroll_reduce_fm"),
                      ("roll_broadcast_kernel", "roll_broadcast_fm"),
                      ("scatter_kernel<", "scatter_level")):
        if name in kernel:
            return key
    return None


def traced(run):
    """``run()`` under ``torch.profiler``: (its result, the device ms of
    every kernel and memset it ran, {launch-count key: kernels of
    ``csrc/`` in the trace}) -- in a graph's replays, the kernels that
    actually ran."""
    import collections

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
        torch.cuda.synchronize()
    dev_ms, counts = 0.0, collections.Counter()
    for ev in prof.key_averages():
        if getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            dev_ms += dev_us / 1e3
            key = _launch_key(ev.key)
            if key:
                counts[key] += ev.count
    return out, dev_ms, dict(counts)


def falling(where: str, losses, k: int):
    """Mean of the first and the last ``k`` losses; fail unless every loss
    is finite and the mean fell."""
    losses = np.asarray(losses, np.float64)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{where}: bad losses {losses}")
    first, last = float(losses[:k].mean()), float(losses[-k:].mean())
    if not last < first:
        raise AssertionError(f"{where}: loss did not fall: first-{k} mean {first}, "
                             f"last-{k} mean {last}")
    return first, last


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def encoder_points(field, rays, n_samples: int, gen):
    """The encoder's inputs for one batch of rays, as the renderer makes
    them: stratified samples clamped into the field's bound and scaled to
    [0, 1]; [rays * n_samples, 3]."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops.sampling import (
        stratified_z_vals)
    z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], n_samples, True, gen)
    b = field.bound - 1e-6
    pts = torch.clamp(rays[:, None, :3] + rays[:, None, 3:6] * z[..., None], -b, b)
    return torch.clamp((pts.reshape(-1, 3) + field.bound) / (2.0 * field.bound), 0, 1)


def sorted_stream(spec, x01):
    """The main path's sorted stream of ``x01``: keys [L, B] and packed
    fracs [L, 1, B]."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        base_and_frac_t)
    base_t, frac_t = base_and_frac_t(spec, x01)
    sk, perm = torch.sort(base_t, dim=-1, stable=True)
    return sk, torch.gather(sg.pack_frac_t(frac_t), 1, perm)[:, None, :].contiguous()


def index_add_call(sk, sf, grads, table_size: int):
    """The one PyTorch call that computes the bucket's gradient (without
    the wrap extension): ``index_add_`` of every update's payload."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops import (
        bucket_matmul as bm)
    L, B = sk.shape
    pay = bm._payload(sf, grads).permute(0, 2, 1).reshape(L * B, -1)
    flat = (sk.long() + torch.arange(L, device=sk.device)[:, None] * table_size).reshape(-1)
    return lambda: torch.zeros((L * table_size, pay.shape[1]),
                               device=sk.device).index_add_(0, flat, pay)


def hold_path_kernels(record, spec, sk, spf, table, grads, span_mode, mode,
                      plain_iters: int = 20) -> None:
    """The kernels of a training path's step on one batch's sorted stream
    (keys ``sk``, packed fracs ``spf``, f32 ``table``, ``grads``): the
    span gather's table mode bit-equal to the rolled mode and to its plain
    version, the bucket bit-equal to its plain version and bit-identical
    twice, the unroll of its gradient atol 1e-5; each timed by ``record``
    under ``span_mode`` (the span gather) and ``mode`` (the bucket and the
    unroll; None for their main entries)."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops import (
        bucket_matmul as bm)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import (
        roll_kernels as rk)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        corner_offsets)
    L, S, C = spec.num_levels, spec.table_size, spec.level_dim
    D, K = spec.input_dim, 1 << spec.input_dim
    F, E, B = K * C, rk._PAD, sk.shape[1]
    bf16 = torch.bfloat16

    # span gather, table mode: the canonical f32 table at the corners'
    # offsets, rounded to bf16 as the roll rounds
    out = sg.span_gather_sorted_table(sk, spf, table, spec, bf16)
    rolled = sg.span_gather_sorted(sk, spf, rk.roll_broadcast_fm(table, spec, bf16),
                                   input_dim=D)
    plain = sg.span_gather_sorted_table_plain(sk, spf, table, spec, bf16)
    torch.cuda.synchronize()
    err = (out - plain).abs().max()
    if not torch.equal(out, rolled):
        raise AssertionError(f"span_gather_sorted[{span_mode}] is not bit-equal to "
                             f"the rolled mode")
    if not torch.equal(out, plain):
        raise AssertionError(f"span_gather_sorted[{span_mode}] is not bit-equal to its "
                             f"plain version (max abs diff {float(err)})")
    del out, rolled, plain
    # bound: keys, packed fracs and output, and the canonical rows that some
    # corner of some key touches, each read once.  Beside it, the 32-byte
    # sectors each mode must fetch at least once: of every rolled row, the
    # sectors that hold a key's column; of the canonical table, those that
    # hold a touched row.
    offs = torch.as_tensor(corner_offsets(spec), device=sk.device).long()
    distinct = touched = sec_rolled = sec_table = 0
    for l in range(L):
        uk = torch.unique_consecutive(sk[l]).long()
        rows = torch.unique((uk[:, None] + offs[l][None, :]) % S)
        distinct += int(uk.numel())
        touched += int(rows.numel())
        sec_rolled += int(torch.unique_consecutive(uk // 16).numel())   # bf16 columns
        sec_table += int(torch.unique_consecutive(rows // (32 // (C * 4))).numel())
    print(f"span_gather_sorted[{span_mode}]: {B} points a level, {distinct} distinct "
          f"keys, {touched} canonical rows touched (of {L * S}); 32-byte sectors to "
          f"fetch: rolled table {sec_rolled * F * 32 / 1e6:.1f} MB ({F} rows), "
          f"canonical table {sec_table * 32 / 1e6:.1f} MB, beside "
          f"{L * B * 4 * (2 + C) / 1e6:.1f} MB of keys, fracs and output")
    record("span_gather_sorted", err,
           lambda: sg.span_gather_sorted_table(sk, spf, table, spec, bf16),
           lambda: sg.span_gather_sorted_table_plain(sk, spf, table, spec, bf16), None,
           L * B * 4 * 2 + touched * C * 4 + L * C * B * 4,
           L * B * (K * D + 2 * K * C), mode=span_mode, plain_iters=plain_iters)

    # bucket: bit-equal to plain, bit-identical twice
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
    # bound of the tile design: keys, fracs and grads read once, the
    # wrap-extended f32 gradient written once (empty columns as zeros)
    record("bucket_grad_matmul", err,
           lambda: bm.bucket_grad_matmul(sk, sf, grads, **kw),
           lambda: bm.bucket_grad_matmul_plain(sk, sf, grads, **kw),
           index_add_call(sk, sf, grads, S),
           L * B * 4 * (1 + D + C) + L * F * (S + E) * 4,
           L * B * (K * D + 2 * K * C), mode=mode, plain_iters=plain_iters)

    # unroll of that gradient: atol 1e-5
    u = rk.unroll_reduce_fm(g1, spec, C)
    err = (u - rk.unroll_reduce_fm_plain(g1, spec, C)).abs().max()
    if not err <= 1e-5:
        raise AssertionError(f"unroll_reduce_fm differs by {float(err)}")
    record("unroll_reduce_fm", err,
           lambda: rk.unroll_reduce_fm(g1, spec, C),
           lambda: rk.unroll_reduce_fm_plain(g1, spec, C), None,
           L * F * S * 4 + L * S * C * 4, L * S * C * (K - 1), mode=mode,
           plain_iters=plain_iters)


def timed(fn):
    """``fn()`` and its wall time in seconds, the card synchronised
    before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def data_side(dev, record, entry_of) -> dict:
    """Phase (e): the projector, the generator, the formatter and the C++
    host engine on the card's paths, and the main path's kernels at the
    real-scan path's shapes (timed by ``record``); returns the ``data``
    JSON line."""
    import torch

    out = {"projector_chest": project_chest(dev)}
    torch.cuda.empty_cache()
    out["lamino_chip"] = lamino_chip(dev, entry_of)
    torch.cuda.empty_cache()
    out["real_scan"] = real_scan(dev, record, entry_of)
    return out


def project_chest(dev) -> dict:
    """e1: the projector on the 50 chest views."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch import geometry as G
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        load_pickle)
    from neuralvolumetricreconstructionformedicalimages_torch.data.projector import (
        project_angles)

    # e1. the projector at full size: the 50 chest views against the
    # stored projections, made by an earlier JAX projector.  Pixels agree
    # to 1e-6, except where a sample lies within an ulp of the edge of the
    # in-volume band: there one program adds a boundary voxel's sample and
    # the other not.  Today's JAX projector differs from the stored views
    # so at 24 pixels, all in views 16 and 34, by up to 5.81e-4 (tests/
    # test_torch_data_gen.py::test_stored_chest_views_against_both_projectors),
    # so pixels over 1e-6 may lie only in those views, no more than 24 of
    # them, each within one such sample.
    chest = load_pickle("data/chest_phantom.pickle")
    geo = G.ConeGeometry.from_dict(chest)
    angles = np.asarray(chest["train"]["angles"], np.float32)
    vol = torch.as_tensor(chest["image"], dtype=torch.float32, device=dev)
    project_angles(vol, geo, angles[:1])                       # warm-up
    proj, wall = timed(lambda: project_angles(vol, geo, angles))
    stored = chest["train"]["projections"]
    err = np.abs(proj.cpu().numpy() - stored)
    top = float(np.abs(stored).max())
    near, far = G.get_near_far(geo)
    n_samples = 2 * max(geo.nVoxel)
    d_max = float(G.rays_for_angle(geo, 0.0, dev)[1].norm(dim=-1).max())
    one_sample = float(chest["image"].max()) * (far - near) / (n_samples - 1) * d_max
    over = err > 1e-6
    views_over = sorted(int(v) for v in np.nonzero(over.any(axis=(1, 2)))[0])
    print(f"e1 projector: {len(angles)} chest views of {geo.nDetector} from "
          f"{geo.nVoxel} x {n_samples} samples in {wall:.3f} s "
          f"({len(angles) / wall:.1f} views/s); against the stored projections "
          f"(max {top:.4g}): max abs err {err.max():.4g}, {int(over.sum())} of "
          f"{err.size} pixels over 1e-6 (views {views_over}), one boundary "
          f"sample {one_sample:.4g}")
    if not (set(views_over) <= E1_VIEWS_OFF and over.sum() <= E1_PIXELS_OFF
            and err.max() <= one_sample + 1e-6):
        raise AssertionError("projector: the chest views differ from the stored ones")
    return dict(
        views=len(angles), detector=list(geo.nDetector), volume=list(geo.nVoxel),
        samples=n_samples, max_abs_err=float(err.max()), max_value=top,
        pixels_over_1e6=int(over.sum()), views_over_1e6=views_over,
        one_sample_bound=one_sample, wall_s=wall, views_per_s=len(angles) / wall)


def lamino_chip(dev, entry_of) -> dict:
    """e2: the lamino_chip scan generated on the card, and one epoch of
    ``configs/lamino_chip.yaml`` on it."""
    import importlib

    import torch
    import yaml

    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
    from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as T
    gen = importlib.import_module(
        "neuralvolumetricreconstructionformedicalimages_torch.data.generate")

    # e2. configs/lamino_chip.yaml on a dataset the generator makes on the card
    with open(LAMINO_SCAN) as f:
        scan = yaml.safe_load(f)
    data, gen_s = timed(lambda: gen.generate(scan, phantom="lamino_chip", seed=0,
                                             device=dev))
    path = os.path.join("logs", "chip_smoke", "lamino_chip.pickle")
    gen.save(data, path)
    tp = data["train"]["projections"]
    lit, pmax = float((tp != 0).mean()), float(tp.max())
    print(f"e2 generate: lamino_chip {scan['nVoxel']}, {scan['numTrain']}"
          f"+{scan['numVal']} views in {gen_s:.3f} s; {lit:.4f} of the pixels "
          f"lit, projection max {pmax:.4g}; saved {path}")
    lcfg = load_config("configs/lamino_chip.yaml")
    lcfg["exp"]["datadir"] = path
    lcfg["train"]["epoch"] = 0     # one epoch: 50 views -> 50 steps
    lcfg["log"]["i_save"] = 0      # no checkpoint
    lcfg["log"]["i_eval"] = 1      # its epoch-0 eval
    tr = T.Trainer(lcfg, workdir=os.path.join("logs", "chip_smoke_lamino"), device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    # the trace counts the kernels that ran (the eval launches none of csrc/)
    (_, _, trace_counts), wall = timed(lambda: traced(tr.start))
    launches = dict(_build.LAUNCHES)
    check_exact("lamino_chip", launches, 50)
    check_exact("lamino_chip (profiler trace)", trace_counts, 50)
    first, last = falling("lamino_chip", tr.losses, 10)
    step_ms = float(np.median(tr.step_ms))
    ev = tr.eval_metrics[0]
    n_rays = tr.n_rays
    res = dict(
        config="configs/lamino_chip.yaml", scan=scan, generate_s=gen_s,
        lit_fraction=lit, projection_max=pmax, steps=len(tr.losses), wall_s=wall,
        median_step_ms=step_ms, rays_per_s=n_rays / (step_ms / 1e3),
        loss_first10=first, loss_last10=last, eval_epoch0=ev, launches=launches,
        trace_counts=trace_counts)
    print(f"e2 lamino_chip: {len(tr.losses)} steps in {wall:.1f} s wall (eval "
          f"included, under the profiler), median step {step_ms:.3f} ms, "
          f"{n_rays / (step_ms / 1e3):.0f} rays/s, loss first-10 {first:.6g} last-10 "
          f"{last:.6g}, launches {launches}, kernels in the trace {trace_counts}")
    print(f"e2 eval (epoch 0): proj_psnr {ev['proj_psnr']:.3f} dB, psnr_3d "
          f"{ev['psnr_3d']:.3f} dB, ssim_3d {ev['ssim_3d']:.4f}")
    for kname in MAIN_NEEDS:
        entry_of(kname).setdefault("path_launches", {})["lamino_chip"] = \
            int(launches.get(kname, 0))
    return res


def real_scan(dev, record, entry_of) -> dict:
    """e3: the 187-view real-scan laminography path, and the main path's
    kernels at its shapes."""
    import torch
    from scipy.ndimage import gaussian_filter

    from neuralvolumetricreconstructionformedicalimages_torch import geometry as G
    from neuralvolumetricreconstructionformedicalimages_torch import native
    from neuralvolumetricreconstructionformedicalimages_torch.config import (
        load_config, with_defaults)
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        gather_view_batch, make_dataset)
    from neuralvolumetricreconstructionformedicalimages_torch.data.format_real import (
        format_real_data)
    from neuralvolumetricreconstructionformedicalimages_torch.data.phantoms import (
        get_phantom)
    from neuralvolumetricreconstructionformedicalimages_torch.data.projector import (
        project_angles)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
    from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as T
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        StepTimer)

    # e3. the real-scan laminography path: the 187 real angles, a smoothed
    # chip phantom projected on the card at 1024^2, a unit-amplitude complex
    # field through the formatter, a beam mask from the C++ engine, rays on
    # the fly, masked loss and masked eval
    angles_deg = np.rad2deg(np.load("data/angles_real.npy").astype(np.float64))[:REAL_VIEWS]
    vol = gaussian_filter(get_phantom("lamino_chip", (256, 256, 64)).astype(np.float32), 1.0)
    rgeo = G.ConeGeometry(
        DSD=1.5, DSO=1.0, nDetector=(REAL_DET, REAL_DET), dDetector=(0.001, 0.001),
        nVoxel=(256, 256, 64), dVoxel=(0.0015, 0.0015, 0.0015),
        mode="parallel", tilt_angle=29.0)
    proj, gen_s = timed(lambda: project_angles(
        vol, rgeo, np.deg2rad(angles_deg).astype(np.float32), REAL_SAMPLES, device=dev))
    proj = proj.cpu().numpy()
    H = W = REAL_DET
    phase_max = 0.9 * float(proj.max()) / max(1e-6, float(vol.max()))
    phase = proj / max(1e-6, proj.max()) * phase_max
    yy, xx = np.mgrid[0:H, 0:W]
    beam = (np.hypot(yy - H / 2, xx - W / 2) < 0.48 * H).astype(np.float32)
    cplx = (beam * np.exp(1j * phase)).astype(np.complex64)
    del proj, phase
    t0 = time.perf_counter()
    data = format_real_data(np.rot90(cplx, k=-1, axes=(1, 2)), angles_deg,
                            tilt_angle=29.0, n_slices=64)
    data.update(nVoxel=[256, 256, 64], dVoxel=[1.5, 1.5, 1.5], offOrigin=[0, 0, 0],
                image=vol)
    format_s = time.perf_counter() - t0
    del cplx
    if not native.available():
        raise AssertionError(f"the C++ host engine did not build: {native.load_error()}")
    cfg = with_defaults(load_config("configs/chest_50.yaml"))
    cfg["exp"].update(expname="chip_smoke_real", datadir="(in-memory)")
    cfg["train"].update(resume=False, n_rays=REAL_RAYS)
    cfg["log"].update(i_eval=0, i_save=0, eval_mask=True)
    # the datasets are built in memory, and the engine's calls that
    # make_dataset makes are timed where they run
    engine_s = {"ptycho_mask_batch": [], "build_pools": []}

    def timed_engine(fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            engine_s[fn.__name__].append(time.perf_counter() - t0)
            return res
        return call

    saved = (T.load_dataset, native.ptycho_mask_batch, native.build_pools)
    T.load_dataset = lambda path, split, n_rays, **kw: make_dataset(
        data, split, n_rays=n_rays, **kw)
    native.ptycho_mask_batch = timed_engine(saved[1])
    native.build_pools = timed_engine(saved[2])
    try:
        tr, load_s = timed(lambda: T.Trainer(
            cfg, workdir=os.path.join("logs", "chip_smoke_real"), device=dev))
        tr.eval_dset = make_dataset(data, "val", n_rays=REAL_RAYS, device=dev)
    finally:
        T.load_dataset, native.ptycho_mask_batch, native.build_pools = saved
    # the train split's calls come first
    mask_s, pools_s = engine_s["ptycho_mask_batch"][0], engine_s["build_pools"][0]
    counts = tr.train_dset.pool_counts
    print(f"e3 generate: {REAL_VIEWS} views of {REAL_DET}^2 x {REAL_SAMPLES} samples "
          f"from (256, 256, 64) in {gen_s:.2f} s ({REAL_VIEWS / gen_s:.1f} views/s); "
          f"format {format_s:.2f} s; C++ engine on the train split: masks "
          f"{mask_s:.3f} s ({float(tr.train_dset.mask.float().mean()):.4f} kept), "
          f"pools {pools_s:.3f} s ({int(counts.min())}-{int(counts.max())} valid "
          f"pixels a view)")
    if tr.train_dset.ray_mode != "onthefly" or not tr.use_mask:
        raise AssertionError(f"real scan: ray_mode {tr.train_dset.ray_mode}, "
                             f"use_mask {tr.use_mask}")
    views = tr._view_order(0)[:TRAIN_STEPS]
    torch.cuda.synchronize()
    _build.reset_launches()
    timer = StepTimer(dev)
    timer.tick()
    rlosses, _, trace_counts = traced(lambda: tr.train_steps(views, timer).cpu().numpy())
    launches = dict(_build.LAUNCHES)
    check_exact("real scan", launches, TRAIN_STEPS)
    check_exact("real scan (profiler trace)", trace_counts, TRAIN_STEPS)
    first, last = falling("real scan", rlosses, 5)
    step_ms = float(np.median(timer.step_ms()))
    ev, eval_s = timed(lambda: tr.eval_step(tr.global_step, 0))
    if not np.isfinite(list(ev.values())).all():
        raise AssertionError(f"real scan: eval metrics not finite: {ev}")
    res = dict(
        views=REAL_VIEWS, detector=[H, W], samples=REAL_SAMPLES, generate_s=gen_s,
        views_per_s=REAL_VIEWS / gen_s, format_s=format_s, mask_s=mask_s,
        pools_s=pools_s, native=native.available(), dataset_s=load_s,
        ray_mode=tr.train_dset.ray_mode, use_mask=tr.use_mask, n_rays=REAL_RAYS,
        steps=len(rlosses), median_step_ms=step_ms,
        rays_per_s=REAL_RAYS / (step_ms / 1e3), loss_first5=first, loss_last5=last,
        eval=ev, eval_s=eval_s, launches=launches, trace_counts=trace_counts)
    print(f"e3 real scan: trainer with its in-memory datasets in {load_s:.2f} s; "
          f"ray_mode {tr.train_dset.ray_mode}, use_mask {tr.use_mask}; "
          f"{len(rlosses)} steps of {REAL_RAYS} rays (under the profiler), median "
          f"{step_ms:.3f} ms, {REAL_RAYS / (step_ms / 1e3):.0f} rays/s, loss first-5 "
          f"{first:.6g} last-5 {last:.6g}, launches {launches}, kernels in the trace "
          f"{trace_counts}")
    print(f"e3 masked eval ({eval_s:.2f} s): " + ", ".join(
        f"{k} {v:.4g}" for k, v in ev.items()))
    for kname in MAIN_NEEDS:
        entry_of(kname).setdefault("path_launches", {})["real_scan"] = \
            int(launches.get(kname, 0))

    # the main path's kernels at this path's shapes: one 4096-ray batch of
    # a view of the steps above, 786,432 sorted points a level (4x the main
    # path's), held against their plain versions as phases 2-4 hold them
    g = torch.Generator(device=dev).manual_seed(1)
    ds = tr.train_dset
    rays = gather_view_batch(tr._arrays, int(views[0][0]), REAL_RAYS, g, geo=ds.geo,
                             near=ds.near, far=ds.far)["rays"]
    spec = tr.field.encoder.grid
    sk, spf = sorted_stream(spec, encoder_points(
        tr.field, rays, int(cfg["render"]["n_samples"]), g))
    del tr, ds, rays
    torch.cuda.empty_cache()
    table = torch.randn((spec.num_levels, spec.table_size, spec.level_dim),
                        generator=g, device=dev)
    grads = torch.randn((spec.num_levels, spec.level_dim, sk.shape[1]),
                        generator=g, device=dev)
    hold_path_kernels(record, spec, sk, spf, table, grads, "table_real_scan",
                      "real_scan", plain_iters=3)
    for key, mode_key in REAL_MODES.items():
        entry_of(mode_key)["launches"] = int(launches.get(key, 0))
    return res




def epoch_numbers(tr, order, graphed: bool) -> dict:
    """One more epoch of ``tr`` on ``order`` timed by events (median step
    ms), and one traced (device ms a step): through the graphed epoch
    function, or the eager ``train_step`` loop."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        StepTimer)

    def epoch(timer=None):
        if graphed:
            return tr.train_steps(order, timer)
        out = []
        for v in order:
            out.append(tr.train_step(v))
            if timer is not None:
                timer.tick()
        return out

    timer = StepTimer(tr.device)
    timer.tick()
    epoch(timer)
    med = float(np.median(timer.step_ms()))
    _, dev_ms, _ = traced(epoch)
    dev_ms /= len(order)
    return dict(median_step_ms=med, device_ms=dev_ms, idle_share=1 - dev_ms / med,
                reserved_mb=torch.cuda.memory_reserved() / 1e6)


def param_checksum(module) -> list:
    """Each parameter tensor's sum and sum of squares, in f64."""
    return [float(x) for p in module.parameters()
            for x in (p.detach().double().sum(), p.detach().double().square().sum())]


def allreduce_ms(module, iters: int = 10) -> float:
    """Median ms of one SUM all-reduce, over the default group, of a buffer
    the size of ``module``'s flat gradient (host clock, the card
    synchronised after each)."""
    import torch
    import torch.distributed as dist

    n = sum(p.numel() for p in module.parameters())
    buf = torch.zeros(n, device=next(module.parameters()).device)
    times = []
    for i in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def train_steps(tr, where: str, steps: int) -> dict:
    """``steps`` steps of ``Trainer.train_steps`` (on a mesh, the sharded
    step's eager loop) with the launch counts set to 0 just before and
    read just after; fails unless each main-path kernel launched in every
    step and the loss is finite and falling."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        StepTimer)
    views = tr._view_order(0)[:steps]
    torch.cuda.synchronize()
    _build.reset_launches()
    timer = StepTimer(tr.device)
    timer.tick()
    losses = tr.train_steps(views, timer).cpu().numpy()
    ms = timer.step_ms()
    launches = dict(_build.LAUNCHES)
    check_launches(where, launches, steps)
    first, last = falling(where, losses, 5)
    return dict(steps=len(losses), losses=[float(x) for x in losses],
                median_step_ms=float(np.median(ms)), loss_first5=first,
                loss_last5=last, launches=launches)


def fed_check(tr, where: str, perturb: bool) -> dict:
    """One sharded step of ``tr``'s mesh fed one 1024-ray batch (and its
    jitter), this rank's share of it, against the single-process step on
    the whole batch, each from a copy of ``tr``'s field: the loss to rtol
    1e-6 (1e-5 with the sample axis split) and every gradient tensor within
    1e-4 of its largest entry."""
    import copy

    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        gather_view_batch)
    from neuralvolumetricreconstructionformedicalimages_torch.parallel.step import (
        make_sharded_train_step)
    from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
        make_optimizer)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        make_loss_fn)
    cfg = copy.deepcopy(tr.cfg)
    cfg["render"]["perturb"] = perturb
    n_rays, n_samples = tr.n_rays, int(cfg["render"]["n_samples"])
    g = torch.Generator(device=tr.device).manual_seed(7)
    whole = gather_view_batch(tr._arrays, 0, n_rays, g)
    t_rand = (torch.rand((n_rays, n_samples), generator=g, device=tr.device)
              if perturb else None)
    ref = copy.deepcopy(tr.field)
    ref_loss = make_loss_fn(cfg, tr.use_mask)(ref, None, whole, t_rand=t_rand)
    ref_loss.backward()
    field = copy.deepcopy(tr.field)
    step = make_sharded_train_step(
        cfg, field, make_optimizer(cfg, field.parameters()), tr.mesh,
        tr.steps_per_epoch, torch.Generator(device=tr.device).manual_seed(0),
        n_rays=n_rays, n_batch=1, use_mask=tr.use_mask)
    n_data = tr.mesh.size(0)
    d = tr.mesh.get_local_rank("data")
    share = slice(d * n_rays // n_data, (d + 1) * n_rays // n_data)
    loss = float(step(tr._arrays, [0], 0,
                      batch={k: whole[k][share] for k in ("rays", "projs", "mask")},
                      t_rand=None if t_rand is None else t_rand[share]))
    rel = max(float((p.grad - q.grad).abs().max() / q.grad.abs().max())
              for p, q in zip(field.parameters(), ref.parameters()))
    loss_rtol = 1e-6 if tr.mesh.size(1) == 1 else 1e-5
    ref_loss = float(ref_loss.detach())
    out = dict(loss=loss, single_process_loss=ref_loss,
               loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
               loss_rtol=loss_rtol, grad_max_rel_err=rel, grad_tol=1e-4)
    print(f"{where} fed batch: {out}")
    if not out["loss_rel_err"] <= loss_rtol or not rel <= 1e-4:
        raise AssertionError(f"{where}: the fed step differs from the single-process "
                             f"step: {out}")
    return out


def parallel_rank(rank: int, world: int, store: str, out_dir: str, cfg_path: str) -> None:
    """Phases f2 and f3 on one of the ranks that share cuda:0 under gloo;
    writes ``rank<r>.json`` to ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        Trainer, pin_fp32)

    torch.cuda.set_device(0)
    pin_fp32()
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PARALLEL_GROUP_TIMEOUT_S))
    try:
        out = {}
        for phase, layout in (("f2", {"data": 2, "sample": 1}),
                              ("f3", {"data": 1, "sample": 2})):
            cfg = load_config(cfg_path)
            cfg["parallel"] = {"mesh": layout}
            cfg["log"].update(i_eval=0, i_save=0)
            tr = Trainer(cfg, workdir=os.path.join("logs", f"chip_smoke_{phase}"),
                         device="cuda:0")
            res = {"mesh": layout, "backend": dist.get_backend()}
            if phase == "f3":     # the loss with perturb off first
                res["fed"] = fed_check(tr, f"{phase} rank {rank}", perturb=False)
            res.update(train_steps(tr, f"{phase} rank {rank}", TRAIN_STEPS))
            res["checksum"] = param_checksum(tr.field)
            res["allreduce_ms"] = allreduce_ms(tr.field)
            if phase == "f2":
                res["fed"] = fed_check(tr, f"{phase} rank {rank}", perturb=True)
            print(f"{phase} rank {rank}: median step {res['median_step_ms']:.3f} ms, "
                  f"gradient all-reduce {res['allreduce_ms']:.3f} ms, loss first-5 "
                  f"{res['loss_first5']:.6g} last-5 {res['loss_last5']:.6g}, "
                  f"launches {res['launches']}", flush=True)
            out[phase] = res
            del tr
            torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def parallel_phase(cfg_path: str, main_losses, smi: str) -> dict:
    """Phase (f); returns the ``parallel`` JSON line's object."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import Trainer

    # f1. a mesh of one on a one-rank NCCL group the trainer makes itself
    cfg = load_config(cfg_path)
    cfg["parallel"] = {"mesh": {"data": 1, "sample": 1}, "force_mesh": True}
    cfg["train"]["epoch"] = 0       # one epoch: 50 views -> 50 steps
    cfg["log"].update(i_eval=0, i_save=0)   # the eval draws nothing
    tr = Trainer(cfg, workdir=os.path.join("logs", "chip_smoke_f1"), device="cuda")
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        _, wall = timed(tr.start)
        launches = dict(_build.LAUNCHES)
        backend = dist.get_backend()
        ar_ms = allreduce_ms(tr.field)
    finally:
        tr.close()
    check_launches("f1", launches, 50)
    if not torch.equal(torch.tensor(tr.losses), torch.tensor(main_losses)):
        raise AssertionError(f"f1: the force_mesh losses differ from phase 4's: "
                             f"{tr.losses} vs {main_losses}")
    f1 = dict(config=cfg_path, mesh=cfg["parallel"], backend=backend,
              steps=len(tr.losses), wall_s=wall,
              median_step_ms=float(np.median(tr.step_ms)), allreduce_ms=ar_ms,
              losses=list(tr.losses), losses_equal_phase4=True, launches=launches)
    print(f"f1 force_mesh ({backend}, one rank): {len(tr.losses)} steps in {wall:.1f} s, "
          f"median step {f1['median_step_ms']:.3f} ms, gradient all-reduce "
          f"{ar_ms:.3f} ms, losses torch.equal to phase 4's, launches {launches}")
    del tr
    torch.cuda.empty_cache()

    # f2, f3. two ranks sharing cuda:0 under gloo
    out_dir = os.path.join("logs", "chip_smoke_f")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    t0 = time.perf_counter()
    ctx = mp.start_processes(parallel_rank, args=(2, store, out_dir, cfg_path),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > PARALLEL_JOIN_S:
                raise AssertionError(f"f2/f3: the ranks did not end in "
                                     f"{PARALLEL_JOIN_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    res = {"f1": f1, "card": smi, "f23_wall_s": time.perf_counter() - t0}
    for phase in ("f2", "f3"):
        if ranks[0][phase]["checksum"] != ranks[1][phase]["checksum"]:
            raise AssertionError(f"{phase}: the ranks' parameters differ")
        res[phase] = {"backend": ranks[0][phase]["backend"],
                      "why_gloo": "two ranks share one card; NCCL refuses that",
                      "mesh": ranks[0][phase]["mesh"],
                      "ranks": [rk[phase] for rk in ranks]}
    print(f"f2/f3: two ranks on cuda:0 in {res['f23_wall_s']:.1f} s; parameters "
          f"equal across the ranks after each phase")
    return res


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
    from neuralvolumetricreconstructionformedicalimages_torch.ops import (
        bucket_matmul as bm)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import (
        roll_kernels as rk)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import (
        scatter_level as sl)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        corner_offsets)
    from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (
        hash_grid_indices, sorted_corner_stream)
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
    x01 = encoder_points(field, rays, n_samples, gen)
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

    # ---- 2. span_gather_sorted (packed fracs, bf16 table), the rolled
    # mode: atol 1e-5 against the plain version ----
    sk, spf = sorted_stream(spec, x01)
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
    del R, out, out_plain

    # ---- 2-4. the main path's kernels on its batch: the span gather's
    # table mode, the bucket and the unroll ----
    hold_path_kernels(record, spec, sk, spf, table, grads, "table", None)
    sf = sg.unpack_frac_t(spf[:, 0])
    kw = dict(table_size=S, input_dim=D, extend_cols=E)
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
    results["bucket_grad_matmul"]["duplicate_heavy"] = dict(
        points=700, max_abs_err=dup_err, ms=dup_ms)

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
           index_add_call(sk, sf, grads, S),
           L * B * 4 * (1 + D + C) + L * F * (S + E) * 2,
           L * B * (K * D + 2 * K * C), mode="bf16_out", plain_iters=3)
    del h_plain
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
    del s1, s_plain, sidx, spay, ipay, iidx, sk, spf, sf
    del table, grads, field, dset
    torch.cuda.empty_cache()

    # ---- 5. the training path: one epoch of chest_phantom_r3, graphed ----
    cfg["train"]["epoch"] = 0      # one epoch: 50 views -> 50 steps
    cfg["log"]["i_save"] = 0       # no checkpoint
    cfg["log"]["i_eval"] = 1       # its epoch-0 eval
    trainer = Trainer(cfg, workdir=os.path.join("logs", "chip_smoke"), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    # one eager step, one capture, 49 replays (Trainer.start runs the epoch
    # function); the trace counts the kernels that ran (the eval launches
    # none of csrc/)
    _, _, trace_counts = traced(trainer.start)
    wall = time.perf_counter() - t0
    peak_graphed = torch.cuda.max_memory_allocated() / 1e6
    launches = dict(_build.LAUNCHES)
    steps = len(trainer.losses)
    print(f"training: {steps} steps in {wall:.1f} s wall (eval included, under the "
          f"profiler), launches {launches}, kernels in the trace {trace_counts}")
    if steps != 50:
        raise AssertionError(f"the main path ran {steps} steps, not 50")
    graphed = trainer._epoch_fn.graphed
    if graphed.graph is None:
        raise AssertionError("the main path's epoch captured no graph")
    check_exact("main path", launches, 50)
    check_exact("main path (profiler trace)", trace_counts, 50)
    for kname in MAIN_NEEDS:
        entry_of(kname)["launches"] = int(launches.get(kname, 0))
    first, last = falling("main path", trainer.losses, 10)
    main_losses = list(trainer.losses)
    step_ms = float(np.median(trainer.step_ms))
    ev = trainer.eval_metrics[0]
    print(f"loss: first-10 mean {first:.6g}, last-10 mean {last:.6g}")
    print(f"step: median {step_ms:.3f} ms, {n_rays / (step_ms / 1e3):.0f} rays/s "
          f"({n_rays} rays x {n_samples} samples per step; the epoch's first "
          f"step eager, with the capture)")
    print(f"eval (epoch 0): proj_psnr {ev['proj_psnr']:.3f} dB, "
          f"psnr_3d {ev['psnr_3d']:.3f} dB, ssim_3d {ev['ssim_3d']:.4f}")
    order = torch.as_tensor(trainer._view_order(0), device=dev)
    # 5 more replayed steps: any host sync raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_steps(order[:5])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if trainer._epoch_fn.graphed.graph is not graphed.graph:
        raise AssertionError("the main path's graph was captured again")
    print("host syncs in 5 replayed steps: 0 (set_sync_debug_mode('error'))")
    modes = {"graphed": epoch_numbers(trainer, order, graphed=True)}
    modes["graphed"]["peak_mb_first_epoch"] = peak_graphed
    del trainer, graphed
    torch.cuda.empty_cache()

    # the same 50 steps through the eager Trainer.train_step loop, from the
    # same seed, after the same eval (it draws nothing): the losses
    # torch.equal to the graphed epoch's
    eager = Trainer(cfg, workdir=os.path.join("logs", "chip_smoke_eager"), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager.eval_step(0, 0)
    eager_losses = torch.stack([eager.train_step(v) for v in order]).cpu()
    peak_eager = torch.cuda.max_memory_allocated() / 1e6
    if not torch.equal(eager_losses, torch.tensor(main_losses)):
        bad = int((eager_losses != torch.tensor(main_losses)).sum())
        raise AssertionError(f"the eager loop's losses differ from the graphed "
                             f"epoch's at {bad} of 50 steps: {eager_losses.tolist()} "
                             f"vs {main_losses}")
    modes["eager"] = epoch_numbers(eager, order, graphed=False)
    modes["eager"]["peak_mb_first_epoch"] = peak_eager
    del eager
    torch.cuda.empty_cache()
    for mode, m in modes.items():
        print(f"{mode} step ({smi}): median {m['median_step_ms']:.3f} ms, "
              f"{n_rays / (m['median_step_ms'] / 1e3):.0f} rays/s, device "
              f"{m['device_ms']:.3f} ms a step, idle share {m['idle_share']:.3f}, peak "
              f"memory {m['peak_mb_first_epoch']:.1f} MB (epoch-0 eval and first "
              f"epoch), reserved {m['reserved_mb']:.1f} MB")
    print("eager loop: 50 losses torch.equal to the graphed epoch's")

    # ---- e. the data side on the card ----
    data_line = data_side(dev, record, entry_of)
    torch.cuda.empty_cache()

    # ---- f. the parallel layer on the card ----
    parallel_line = parallel_phase(cfg_path, main_losses, smi)
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
        plosses, _, ptrace = traced(lambda: tr.train_steps(views, timer).cpu().numpy())
        pms = timer.step_ms()
        plaunch = dict(_build.LAUNCHES)
        check_exact(f"{pname} path", plaunch, TRAIN_STEPS, need)
        check_exact(f"{pname} path (profiler trace)", ptrace, TRAIN_STEPS, need)
        pf, pl = falling(f"{pname} path", plosses, 5)
        pmed = float(np.median(pms))
        paths[pname] = dict(encoder=enc_over, steps=len(plosses), median_step_ms=pmed,
                            rays_per_s=n_rays / (pmed / 1e3), loss_first5=pf,
                            loss_last5=pl, launches=plaunch, trace_counts=ptrace)
        print(f"path {pname}: {len(plosses)} steps (under the profiler), median "
              f"{pmed:.3f} ms, {n_rays / (pmed / 1e3):.0f} rays/s, loss first-5 "
              f"{pf:.6g} last-5 {pl:.6g}, launches {plaunch}, kernels in the trace "
              f"{ptrace}")
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
    print(json.dumps({"data": data_line, "card": smi}))
    print(json.dumps({"parallel": parallel_line}))
    print(json.dumps({"kernels": line, "train": {
        "config": cfg_path, "steps": steps, "median_step_ms": step_ms,
        "rays_per_s": n_rays / (step_ms / 1e3), "loss_first10": first,
        "loss_last10": last, "eval_epoch0": ev, "trace_counts": trace_counts,
        "eager_losses_equal": True, "modes": modes}, "paths": paths,
        "microbench": bench_rows, "card": smi}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
