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
   atol 1e-5; and the kernels the main path runs around its sort, each
   ``torch.equal`` to its plain version: the index kernel (``encode_index``),
   the span gather's point-order mode (``span_gather_sorted[table,point_order]``:
   the table mode reading and writing through the sort's permutation), the
   features' transpose and widening (``unpack_feats_t``), the gradient's
   transpose (``transpose_grad_t``) and the gradient-permute kernel
   (``encode_grad_permute``);
3. times each kernel, its plain version and (where one PyTorch call
   computes the same function: ``torch.gather`` for the roll,
   ``index_add_`` for the bucket, the unroll and the scatter) that call
   with ``utils/profiling.py::
   time_fn`` (CUDA events around each call; the median), beside the
   least time the card could take (bytes over 3.35 TB/s, or f32
   operations over 67 TFLOP/s, whichever is larger; beside the span
   gather's rolled-mode bound it prints the 32-byte sectors of its rolled
   rows that hold a key's column, since a key's values lie in 16 rows S
   apart); the kernel and the
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
5. prints the data side's, the parallel layer's, the configuration
   classes' and the real scale's results and the kernels, one JSON line
   each, then the card's
   name and power limit and, as the last line,
   ``{"ok": true, "device": {...}}``.

Phases of the other encoder paths, on the same inputs (before 4, while
the main-path inputs are alive, and after it), of the data side and the
parallel layer (after 4, before c), of the configuration classes, and of
the real scan at scale and the batch sweep (last):

a. the kernels in the modes the other paths run: the bucket with a bf16
   output (bit-equal: one rounding of the same f32 sums), the unroll on that bf16
   gradient (atol 1e-5), the XOR path's index kernel (``xor_index``: corner
   rows, weights and in-cell positions, ``torch.equal`` to its plain
   version) on the same points, and the bucket at D=0 on the
   1,572,864-long XOR stream of those points (bit-equal, bit-identical
   twice);
b. ``scatter_level`` at N = 1,572,864, S = 2^19, C = 2: ``torch.equal`` to
   the in-order sum (the plain version on a CPU copy) on normal payloads
   and with a 700-update column, bit-identical across two launches; beside
   its event time, its device time and ``index_add_``'s at the same int32
   index (back to back; the profiler's per-kernel times overlap, as the
   accumulate launches early and waits for the partition); against
   ``index_add_`` back to back in five alternating rounds; and timed on two
   skewed streams, every update in one slab and 700 updates in one row
   (modes ``one_slab`` and ``hot_row``);
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
       ``data/format_real.py`` (both by ``scripts/real_scale_train_r5_torch.py``),
       beam masks and pools from the C++ host engine (``native/``); the
       formatter, the trainer's construction (its train dataset, not the
       val one) and the engine's calls are each timed where they run,
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
       graphed sharded epoch (one eager step, one capture, 49 replays);
       its 50 losses ``torch.equal`` to phase 4's and to the same mesh's
       eager ``train_step`` loop from the seed; the table mode, the bucket
       and the unroll exactly once a step by the replay-aware counts and
       by a profiler trace, and one gradient all-reduce a step by the
       count (NCCL's device work in the trace printed beside it); 5 more
       replays under ``set_sync_debug_mode("error")``; the graphed and the
       eager mesh-of-one step (median ms, device ms, idle share, peak
       memory);
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
   and f3's times are not those of NCCL across cards;
g. the configuration classes of ``scripts/config_matrix_*_torch.py`` and
   the chest datasets, after d: ``configs/chest_50.yaml`` at full width
   (1024 rays a step) through ``Trainer.train_steps``, 20 graphed steps a
   path, each driven with the launch counts set to 0 just before and read
   just after:
   g1. abdomen: 576 samples a ray on ``data/abdomen_smooth.pickle``; then
       the span gather's table mode, the bucket and the unroll held against
       their plain versions as in 2-4 on one batch of it (589,824 sorted
       points a level), under the modes ``table_abdomen`` and ``abdomen``;
   g2. foot: 320 samples, a tanh head, on ``data/foot_smooth.pickle``; its
       20 losses ``torch.equal`` to 20 eager ``train_step`` steps of a
       second trainer from the same seed;
   g3. jaw: 320 samples, no head activation, on ``data/jaw_smooth.pickle``,
       whose 2-D ``full_proj`` gives the beam mask (``use_mask`` true), and
       one eval;
   g4. ``configs/chest_phantom_tvd.yaml`` (the TV-D term under capture),
       ``torch.equal`` to its eager loop as g2;
   g5. ``data/chest_phantom_smooth.pickle`` and
       ``data/chest_phantom_views{100,200}.pickle`` made on the card by
       ``scripts/make_smooth_phantom_torch.py`` and
       ``scripts/make_view_sweep_data_torch.py``, the stored 50 views
       reprojected and held to e1's rule, then
       ``configs/chest_phantom_views200_b01.yaml``;
   each path must launch the table mode, the bucket and the unroll exactly
   once a step and the roll build and the rolled mode never, by the
   replay-aware counts and by a profiler trace of its steps, with a
   finite, falling loss; its median step ms, device ms a step and peak
   memory print on a line of its own, and a ``configs`` JSON line before
   the kernels line.
h. the real scan at scale and the batch sweep, after g, each driven with
   the launch counts set to 0 just before it and read just after:
   h1. ``scripts/real_scale_smoke_torch.py``'s path at full size: 187
       random views of 1024^2 at the measured angles (rays on the fly,
       unmasked), ``configs/chest_50.yaml`` at 1024 rays x 192 samples
       through ``make_epoch_fn``, a warm-up epoch of 4 steps and 2 timed
       ones; ms a step and peak memory;
   h2. ``scripts/batch_sweep_torch.py --batches 1024,8192 --dtypes
       bfloat16 --steps 8`` as a subprocess (each configuration in a
       process of its own): every figure of its ``SWEEPREC`` lines finite,
       each harness's kernels exactly once a step in its timed blocks;
   h3. 4 graphed steps at 8,192 rays on the sweep's scan, then the span
       gather's table mode, the bucket and the unroll held against their
       plain versions as in 2-4 on one batch of it (1,572,864 sorted points
       a level, the largest shape the kernels are held at), under the modes
       ``table_batch8192`` and ``batch8192`` of the kernels line;
   h1 and h3 must launch the table mode, the bucket and the unroll exactly
   once a step and the roll build and the rolled mode never (the forward
   is not chunked), by the replay-aware counts and by a profiler trace; a
   ``real_scale`` JSON line before the kernels line.
i. the last JAX scripts' paths, after h, each driven with the launch
   counts set to 0 just before it and read just after:
   i1. ``scripts/verify_drive_torch.py``'s drive whole (8 levels x 2^15
       f32 table, ``relu`` head, 1024 rays x 96 samples, 35 blocks of 100
       graphed steps, the first under the profiler): ``VERIFY PASS`` under
       the JAX script's thresholds, the table mode, the bucket and the
       unroll exactly once a step by count (3,500) and by trace (100 in
       the first block); then the three held against their plain versions
       at that shape (98,304 sorted points a level, the drive's f32
       table), modes ``table_verify`` and ``verify`` of the kernels line;
   i2. ``configs/chest_phantom_r3.yaml`` for two epochs with a checkpoint
       each, then ``chest_phantom_consolidate.yaml`` and
       ``chest_phantom_finetune.yaml`` (256 samples) one epoch each, each
       resuming the last checkpoint, consolidate with ``lrate_step`` 2 and
       finetune with 1, so that at each resumed epoch the new config's rate
       differs from the one the checkpoint holds: the resumed epoch and
       step, the rate on
       the card equal to the new config's schedule, Adam's step counts on
       the card, the graphed losses ``torch.equal`` to an eager resume from
       the same checkpoint, the kernels once a step by count and trace;
   i3. ``scripts/multiprocess_smoke_torch.py``: two gloo ranks sharing
       cuda:0 meet through ``initialize_multihost`` on a free port, take
       two sharded steps and must hold identical parameter digests;
   i4. ``scripts/shard_overhead_torch.py`` at 8 steps: the graphed plain
       step, the graphed mesh-of-one step (NCCL) and its eager step, the
       all-reduce of the gradient's payload on one NCCL rank and on two
       gloo ranks;
   i5. ``scripts/scaling_sweep_torch.py`` at 1 and 2 ranks sharing
       cuda:0, finite rays/s; a ``scripts`` JSON line before the kernels
       line.

Wherever a training path below must launch "the table mode" once a
step, the main path's route is meant: the span gather's point-order mode,
the index kernel, the features' unpack, the gradient's transpose and the
gradient-permute kernel once a step each, the plain table mode never;
where the kernels are held at a path's shape, those five are held and
timed beside the others, under the same modes.

The bucket is the tile design of ``csrc/bucket_matmul.cu`` (one block per
1024-column tile with two searches per tile, slice blocks for runs of
2048 or more, every run summed in stream order) and is bit-equal to its
plain version in all three modes; the roll build is the column-pair
kernel of ``csrc/roll_kernels.cu`` (vector loads and stores); the span
gather's table mode reads each corner's channel pair of the canonical
table as one float2; ``scatter_level`` partitions the updates stably by
slab of rows and sums each slab in update order in one block (two kernels:
``scatter_partition_kernel`` and ``scatter_kernel``, the one a trace counts
as the launch).

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
           "scatter_level": "scatter_level", "encode_index": "encode_io",
           "unpack_feats_t": "encode_io", "transpose_grad_t": "encode_io",
           "encode_grad_permute": "encode_io", "xor_index": "encode_io",
           "xor_corner_sort": "corner_sort"}
_TPU = "neuralvolumetricreconstructionformedicalimages_tpu/"
_REPLACES = {"roll_broadcast_fm": _TPU + "ops/roll_kernels.py:152",
             "span_gather_sorted": _TPU + "ops/span_gather.py:282",
             "bucket_grad_matmul": _TPU + "ops/bucket_matmul.py:261",
             "unroll_reduce_fm": _TPU + "ops/roll_kernels.py:192",
             "scatter_level": "scripts/microbench_encoder.py:142",
             "encode_index": "no TPU kernel: PyTorch ops (ops/coherent_hash.py::"
                             "base_and_frac_t, ops/span_gather.py::pack_frac_t)",
             "unpack_feats_t": "no TPU kernel: PyTorch ops (ops/span_gather.py::"
                               "_unpack_feats of a transpose)",
             "transpose_grad_t": "no TPU kernel: a strided read of the gradient "
                                 "inside the PyTorch gather",
             "encode_grad_permute": "no TPU kernel: PyTorch ops (ops/span_gather.py::"
                                    "unpack_frac_t, a gather of the gradient)",
             "xor_index": "no TPU kernel: PyTorch ops (ops/hash_encoding.py::"
                          "_indices_weights_frac_plain)",
             "xor_corner_sort": "no TPU kernel: torch.sort and a gather (ops/"
                                "hash_encoding.py::sorted_corner_stream_plain)"}
# Phase (f): the two shared-card ranks' group times out after this; the
# parent kills them after PARALLEL_JOIN_S.
PARALLEL_GROUP_TIMEOUT_S, PARALLEL_JOIN_S = 120, 300
# The main path's kernels: launched in every step (True) or never (False).
MAIN_NEEDS = {"span_gather_sorted[table,point_order]": True, "encode_index": True,
              "unpack_feats_t": True, "transpose_grad_t": True,
              "encode_grad_permute": True, "bucket_grad_matmul": True,
              "unroll_reduce_fm": True, "span_gather_sorted[table]": False,
              "span_gather_sorted": False, "roll_broadcast_fm": False,
              "xor_index": False, "xor_corner_sort": False}
# The kernels of the main path's route around its sort
ROUTE = ("span_gather_sorted[table,point_order]", "encode_index", "unpack_feats_t",
         "transpose_grad_t", "encode_grad_permute")
# The other encoder paths of phase (d): overrides of the cfg's encoder and
# the kernels that must launch in every step (True) or never (False).
TRAIN_STEPS = 20
PATHS = {
    "xor": ({"hash_variant": "xor"},
            {"bucket_grad_matmul": True, "xor_index": True, "xor_corner_sort": True,
             "span_gather_sorted": False,
             "span_gather_sorted[table]": False, "unroll_reduce_fm": False,
             "roll_broadcast_fm": False, **{k: False for k in ROUTE}}),
    "rolled": ({"forward": "rolled", "input_grads": True, "table_dtype": "bfloat16"},
               {"roll_broadcast_fm": True, "bucket_grad_matmul": True,
                "unroll_reduce_fm": True, "span_gather_sorted": False,
                "span_gather_sorted[table]": False, "xor_index": False,
                "xor_corner_sort": False, **{k: False for k in ROUTE}}),
    "take": ({"backward": "take"},
             {k: False for k in (*_SOURCE, "span_gather_sorted[table]", *ROUTE)}),
}


# Phase (e): the scan of the dataset configs/lamino_chip.yaml trains on,
# and the real-scan path's rays a step.
LAMINO_SCAN = "configs/scans/lamino_chip.yaml"
REAL_RAYS = 4096


def route_modes(mode: str) -> dict:
    """The kernels-line entries of the main path's route at a path's shape
    (``hold_path_kernels`` with ``x01``), by launch count key."""
    return {ROUTE[0]: f"span_gather_sorted[table_{mode},point_order]",
            **{k: f"{k}[{mode}]" for k in ROUTE[1:]}}


# e3: the kernels-line entries of the main path's kernels at the real-scan
# shapes, by launch count key
REAL_MODES = {"span_gather_sorted[table]": "span_gather_sorted[table_real_scan]",
              "bucket_grad_matmul": "bucket_grad_matmul[real_scan]",
              "unroll_reduce_fm": "unroll_reduce_fm[real_scan]",
              **route_modes("real_scan")}
# Phase (g): the same at the abdomen envelope's shapes (576 samples a ray)
ABDOMEN_MODES = {"span_gather_sorted[table]": "span_gather_sorted[table_abdomen]",
                 "bucket_grad_matmul": "bucket_grad_matmul[abdomen]",
                 "unroll_reduce_fm": "unroll_reduce_fm[abdomen]",
                 **route_modes("abdomen")}
# Phase (h): the batch sweep's ray counts (one table dtype), the steps of
# h3's 8,192-ray epoch, and the kernels-line entries at its shape
SWEEP_ARGS = ["--batches", "1024,8192", "--dtypes", "bfloat16", "--steps", "8"]
BATCH_RAYS, BATCH_STEPS = 8192, 4
BATCH_MODES = {"span_gather_sorted[table]": "span_gather_sorted[table_batch8192]",
               "bucket_grad_matmul": "bucket_grad_matmul[batch8192]",
               "unroll_reduce_fm": "unroll_reduce_fm[batch8192]",
               **route_modes("batch8192")}
# Phase (i): the kernels-line entries at the verify drive's shape, the
# resumes (config, epoch, StepLR period in epochs) and the scaling sweep's
# rank counts
VERIFY_MODES = {"span_gather_sorted[table]": "span_gather_sorted[table_verify]",
                "bucket_grad_matmul": "bucket_grad_matmul[verify]",
                "unroll_reduce_fm": "unroll_reduce_fm[verify]",
                **route_modes("verify")}
# consolidate's period fires the decay at its resumed epoch (the checkpoint
# holds lrate, the new config gives lrate*gamma); finetune's gives gamma^3
# where the checkpoint holds gamma^1, so a rate kept from it would fail
RESUMES = (("consolidate", 2, 2), ("finetune", 3, 1))
SWEEP_RANKS = (1, 2)


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
    (the span gather's mode is its fourth template argument, 0 = rolled,
    and its fifth ``true`` in the point-order mode), or None for any other
    kernel."""
    import re

    if "span_gather_kernel<" in kernel:
        args = re.search(r"span_gather_kernel<([^>]*)>", kernel).group(1).split(",")
        if args[3].strip() == "0":
            return "span_gather_sorted"
        return ROUTE[0] if args[4].strip() == "true" else "span_gather_sorted[table]"
    for name, key in (("encode_index_kernel", "encode_index"),
                      ("unpack_feats_kernel", "unpack_feats_t"),
                      ("transpose_grad_kernel", "transpose_grad_t"),
                      ("encode_grad_permute_kernel", "encode_grad_permute"),
                      ("xor_index_kernel", "xor_index"),
                      ("corner_payload_kernel", "xor_corner_sort"),
                      ("bucket_kernel<", "bucket_grad_matmul"),
                      ("unroll_reduce_kernel<", "unroll_reduce_fm"),
                      ("roll_broadcast_kernel", "roll_broadcast_fm"),
                      ("scatter_kernel<", "scatter_level")):
        if name in kernel:
            return key
    return None


def traced(run):
    """``run()`` under ``torch.profiler``: (its result, the device ms of
    every kernel and memset it ran but the range marks, {launch-count key:
    kernels of ``csrc/`` in the trace}) -- in a graph's replays, the
    kernels that actually ran."""
    import collections

    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        traced_device_ms)
    out, dev_ms, kernels, _ = traced_device_ms(run)
    counts = collections.Counter()
    for name, (_, n) in kernels.items():
        key = _launch_key(name)
        if key:
            counts[key] += n
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


def unroll_index_add_call(grad_ext, spec, C: int):
    """The one PyTorch call that computes the unroll: ``index_add_`` of the
    whole flattened rolled gradient (wrap extension included) into the flat
    canonical gradient at a precomputed index, ``R[l, k*C+c, s]`` to ``G[l,
    (s + off[l,k]) % S, c]`` and the extension's columns to one spare entry
    at the end.  ``index_add_`` sums one dtype, so a bf16 gradient is added
    from an f32 copy made here, outside the timed call.  Fails unless its
    result matches the kernel's to rtol/atol 1e-5 (its adds are atomic, in
    no fixed order)."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops import (
        roll_kernels as rk)
    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        corner_offsets)
    dev = grad_ext.device
    L, F, Se = grad_ext.shape
    S, K = Se - rk._PAD, F // C
    offs = torch.as_tensor(corner_offsets(spec), device=dev).long()     # [L, K]
    s = torch.arange(Se, device=dev)
    idx = ((torch.arange(L, device=dev)[:, None, None, None] * S
            + (s + offs[:, :, None, None]) % S) * C
           + torch.arange(C, device=dev)[None, None, :, None])          # [L, K, C, Se]
    idx = torch.where(s < S, idx, L * S * C).reshape(-1).to(torch.int32)
    src = grad_ext.float().reshape(-1)
    call = lambda: torch.zeros(L * S * C + 1, device=dev).index_add_(0, idx, src)  # noqa: E731
    torch.testing.assert_close(call()[:-1].view(L, S, C),
                               rk.unroll_reduce_fm(grad_ext, spec, C), rtol=1e-5, atol=1e-5)
    return call


def stream_counts(spec, sk):
    """What the span gather must read for the sorted keys ``sk`` [L, B]:
    the distinct keys, the canonical rows that some corner of some key
    touches, and the 32-byte sectors each mode must fetch at least once --
    of every rolled row (bf16, 16 columns a sector), those that hold a
    key's column; of the canonical table, those that hold a touched row.
    Each summed over the levels."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        corner_offsets)
    S, C = spec.table_size, spec.level_dim
    offs = torch.as_tensor(corner_offsets(spec), device=sk.device).long()
    distinct = touched = sec_rolled = sec_table = 0
    for l in range(spec.num_levels):
        uk = torch.unique_consecutive(sk[l]).long()
        rows = torch.unique((uk[:, None] + offs[l][None, :]) % S)
        distinct += int(uk.numel())
        touched += int(rows.numel())
        sec_rolled += int(torch.unique_consecutive(uk // 16).numel())
        sec_table += int(torch.unique_consecutive(rows // (32 // (C * 4))).numel())
    return distinct, touched, sec_rolled, sec_table


def hold_path_kernels(record, spec, sk, spf, table, grads, span_mode, mode,
                      plain_iters: int = 20, table_dtype=None, x01=None) -> None:
    """The kernels of a training path's step on one batch's sorted stream
    (keys ``sk``, packed fracs ``spf``, f32 ``table``, ``grads``): the
    span gather's table mode bit-equal to the rolled mode and to its plain
    version, the bucket bit-equal to its plain version and bit-identical
    twice, the unroll of its gradient atol 1e-5; each timed by ``record``
    under ``span_mode`` (the span gather) and ``mode`` (the bucket and the
    unroll; None for their main entries).  The gather rounds the table to
    ``table_dtype`` (default bf16, the chest_50 model's).  With the batch's
    points ``x01`` (whose sorted stream ``sk``, ``spf`` is), the main
    path's kernels around its sort too: the index kernel and the
    gradient-permute kernel under ``mode``, the span gather's point-order
    mode under ``<span_mode>,point_order``, each ``torch.equal`` to its
    plain version."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops import (
        bucket_matmul as bm)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import (
        roll_kernels as rk)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
    L, S, C = spec.num_levels, spec.table_size, spec.level_dim
    D, K = spec.input_dim, 1 << spec.input_dim
    F, E, B = K * C, rk._PAD, sk.shape[1]
    tdt = torch.bfloat16 if table_dtype is None else table_dtype

    # span gather, table mode: the canonical f32 table at the corners'
    # offsets, rounded to the table dtype as the roll rounds
    out = sg.span_gather_sorted_table(sk, spf, table, spec, tdt)
    rolled = sg.span_gather_sorted(sk, spf, rk.roll_broadcast_fm(table, spec, tdt),
                                   input_dim=D)
    plain = sg.span_gather_sorted_table_plain(sk, spf, table, spec, tdt)
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
    # sectors each mode must fetch at least once.
    distinct, touched, sec_rolled, sec_table = stream_counts(spec, sk)
    print(f"span_gather_sorted[{span_mode}]: {B} points a level, {distinct} distinct "
          f"keys, {touched} canonical rows touched (of {L * S}); 32-byte sectors to "
          f"fetch: rolled table {sec_rolled * F * 32 / 1e6:.1f} MB ({F} rows), "
          f"canonical table {sec_table * 32 / 1e6:.1f} MB, beside "
          f"{L * B * 4 * (2 + C) / 1e6:.1f} MB of keys, fracs and output")
    record("span_gather_sorted", err,
           lambda: sg.span_gather_sorted_table(sk, spf, table, spec, tdt),
           lambda: sg.span_gather_sorted_table_plain(sk, spf, table, spec, tdt), None,
           L * B * 4 * 2 + touched * C * 4 + L * C * B * 4,
           L * B * (K * D + 2 * K * C), mode=span_mode, plain_iters=plain_iters)
    if x01 is not None:
        hold_route_kernels(record, spec, x01, table, grads, tdt, touched, span_mode,
                           mode, plain_iters)

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
           lambda: rk.unroll_reduce_fm_plain(g1, spec, C),
           unroll_index_add_call(g1, spec, C),
           L * F * S * 4 + L * S * C * 4, L * S * C * (K - 1), mode=mode,
           plain_iters=plain_iters)


def hold_route_kernels(record, spec, x01, table, grads, tdt, touched, span_mode, mode,
                       plain_iters: int) -> None:
    """The main path's kernels around its sort on one batch's points
    ``x01`` [B, 3]: the index kernel, the span gather's point-order mode,
    the features' unpack, the gradient's transpose and the gradient-permute
    kernel (``grads`` [L, C, B] in point order
    taken as the output gradient), each ``torch.equal`` to its plain
    version and to the PyTorch ops it replaces, and timed by ``record``.
    Bounds: each input byte read once, each output byte written once
    (``touched`` canonical rows of the table)."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        base_and_frac_t)
    L, C, D = spec.num_levels, spec.level_dim, spec.input_dim
    K, B = 1 << D, x01.shape[0]

    def check(name, got, plain, ops):
        if not all(torch.equal(a, b) for a, b in zip(got, plain)):
            raise AssertionError(f"{name} is not bit-equal to its plain version")
        if not all(torch.equal(a, b) for a, b in zip(got, ops)):
            raise AssertionError(f"{name} is not bit-equal to the PyTorch ops")
        return 0.0

    base, pos = sg.encode_index(spec, x01)
    base_t, frac_t = base_and_frac_t(spec, x01)
    err = check("encode_index", (base, pos), sg.encode_index_plain(spec, x01),
                (base_t, sg.pack_frac_t(frac_t)))
    del base_t, frac_t
    record("encode_index", err, lambda: sg.encode_index(spec, x01),
           lambda: sg.encode_index_plain(spec, x01), None, B * D * 4 + 2 * L * B * 4, 0,
           mode=mode, plain_iters=plain_iters)

    sk, perm = torch.sort(base, dim=-1, stable=True)
    spf, feats = sg.span_gather_point_order(sk, perm, pos, table, spec, tdt)
    fs = sg.span_gather_sorted_table(sk, spf[:, None, :], table, spec, tdt)
    packed = sg._pack_feats(fs)
    err = check("span_gather_sorted[table,point_order]", (spf, feats),
                sg.span_gather_point_order_plain(sk, perm, pos, table, spec, tdt),
                (torch.gather(pos, 1, perm),
                 torch.empty_like(packed).scatter_(1, perm, packed)))
    del fs, packed
    record("span_gather_sorted", err,
           lambda: sg.span_gather_point_order(sk, perm, pos, table, spec, tdt),
           lambda: sg.span_gather_point_order_plain(sk, perm, pos, table, spec, tdt),
           None, L * B * (4 + 8 + 4 + 4 + 4) + touched * C * 4,
           L * B * (K * D + 2 * K * C), mode=f"{span_mode},point_order",
           plain_iters=plain_iters)

    err = check("unpack_feats_t", (sg.unpack_feats_t(feats),),
                (sg.unpack_feats_t_plain(feats),),
                (sg._unpack_feats(feats.t()).reshape(B, L * C),))
    record("unpack_feats_t", err, lambda: sg.unpack_feats_t(feats),
           lambda: sg.unpack_feats_t_plain(feats), None, L * B * (4 + C * 4), 0,
           mode=mode, plain_iters=plain_iters)

    g = grads.permute(2, 0, 1).reshape(B, L * C).contiguous()
    gT = sg.transpose_grad_t(g, L)
    err = check("transpose_grad_t", (gT,), (sg.transpose_grad_t_plain(g, L),),
                (grads.permute(0, 2, 1),))
    record("transpose_grad_t", err, lambda: sg.transpose_grad_t(g, L),
           lambda: sg.transpose_grad_t_plain(g, L), None, 2 * L * B * C * 4, 0,
           mode=mode, plain_iters=plain_iters)
    sg_ops = torch.gather(grads, 2, perm[:, None, :].expand(L, C, B))
    err = check("encode_grad_permute", sg.encode_grad_permute(perm, spf, gT),
                sg.encode_grad_permute_plain(perm, spf, gT),
                (sg_ops, sg.unpack_frac_t(spf)))
    del sg_ops
    record("encode_grad_permute", err, lambda: sg.encode_grad_permute(perm, spf, gT),
           lambda: sg.encode_grad_permute_plain(perm, spf, gT), None,
           L * B * (8 + 4 + 8 + C * 4 + D * 4), 0, mode=mode, plain_iters=plain_iters)


def scatter_against_library(kernel, library, rounds: int = 5) -> dict:
    """The scatter's requirement, no slower on the device than
    ``index_add_``: both back to back (``device_times``), alternating, in
    ``rounds`` rounds; how many rounds it held in."""
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        device_times)
    k, lib = [], []
    for _ in range(rounds):
        k.append(device_times(kernel)["back_to_back_ms"])
        lib.append(device_times(library)["back_to_back_ms"])
    held = sum(a <= b for a, b in zip(k, lib))
    print(f"scatter_level against index_add_ (int32 index), {rounds} rounds back "
          f"to back: kernel {' '.join('%.4f' % t for t in k)} ms, library "
          f"{' '.join('%.4f' % t for t in lib)} ms; no slower in {held} of {rounds}")
    return {"kernel_ms": k, "library_ms": lib, "rounds_held": held}


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
    # them, each within one such sample (make_view_sweep_data_torch.
    # check_reprojection).
    import make_view_sweep_data_torch as sweep

    chest = load_pickle("data/chest_phantom.pickle")
    geo = G.ConeGeometry.from_dict(chest)
    angles = np.asarray(chest["train"]["angles"], np.float32)
    vol = torch.as_tensor(chest["image"], dtype=torch.float32, device=dev)
    project_angles(vol, geo, angles[:1])                       # warm-up
    proj, wall = timed(lambda: project_angles(vol, geo, angles))
    res = sweep.check_reprojection(chest, proj.cpu().numpy())
    print(f"e1 projector: {len(angles)} chest views of {geo.nDetector} from "
          f"{geo.nVoxel} x {res['samples']} samples in {wall:.3f} s "
          f"({len(angles) / wall:.1f} views/s); against the stored projections "
          f"(max {res['max_value']:.4g}): max abs err {res['max_abs_err']:.4g}, "
          f"{res['pixels_over_1e6']} of {res['pixels']} pixels over 1e-6 (views "
          f"{res['views_over_1e6']}), one boundary sample {res['one_sample_bound']:.4g}")
    return dict(views=len(angles), detector=list(geo.nDetector), volume=list(geo.nVoxel),
                wall_s=wall, views_per_s=len(angles) / wall, **res)


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

    import real_scale_train_r5_torch as r5
    from neuralvolumetricreconstructionformedicalimages_torch import native
    from neuralvolumetricreconstructionformedicalimages_torch.config import (
        load_config, with_defaults)
    from neuralvolumetricreconstructionformedicalimages_torch.data import format_real
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        gather_view_batch)
    from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as T

    # e3. the real-scan laminography path: the 187 real angles, a smoothed
    # chip phantom projected on the card at 1024^2, a unit-amplitude complex
    # field through the formatter (scripts/real_scale_train_r5_torch.py's
    # make_data), a beam mask from the C++ engine, rays on the fly, masked
    # loss and masked eval
    angles_deg = r5.real_angles_deg()
    rgeo, vol = r5.gen_geo_vol()
    proj, gen_s = timed(lambda: r5.project(vol, rgeo, angles_deg, dev))
    H, W = r5.H, r5.W
    if not native.available():
        raise AssertionError(f"the C++ host engine did not build: {native.load_error()}")
    cfg = with_defaults(load_config("configs/chest_50.yaml"))
    cfg["exp"].update(expname="chip_smoke_real", datadir="(in-memory)")
    cfg["train"].update(resume=False, n_rays=REAL_RAYS)
    cfg["log"].update(i_eval=0, i_save=0, eval_mask=True)
    # the formatter, the trainer (with its train dataset) and the engine's
    # calls run inside make_data and in_memory_trainer, and each is timed
    # where it runs: format_s is the formatter alone, dataset_s the
    # trainer's construction without the val dataset built after it
    engine_s = {"format_real_data": [], "Trainer": [], "ptycho_mask_batch": [],
                "build_pools": []}

    def timed_call(fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            engine_s[fn.__name__].append(time.perf_counter() - t0)
            return res
        return call

    hooks = [(format_real, "format_real_data"), (T, "Trainer"),
             (native, "ptycho_mask_batch"), (native, "build_pools")]
    saved = [getattr(mod, name) for mod, name in hooks]
    for (mod, name), fn in zip(hooks, saved):
        setattr(mod, name, timed_call(fn))
    try:
        data = r5.make_data(proj, vol, angles_deg)    # the phase and the field freed
        del proj
        tr = r5.in_memory_trainer(cfg, data, os.path.join("logs", "chip_smoke_real"), dev)
    finally:
        for (mod, name), fn in zip(hooks, saved):
            setattr(mod, name, fn)
    format_s, load_s = engine_s["format_real_data"][0], engine_s["Trainer"][0]
    # the train split's calls come first
    mask_s, pools_s = engine_s["ptycho_mask_batch"][0], engine_s["build_pools"][0]
    counts = tr.train_dset.pool_counts
    print(f"e3 generate: {r5.N_VIEWS} views of {H}x{W} x {r5.GEN_SAMPLES} samples "
          f"from {vol.shape} in {gen_s:.2f} s ({r5.N_VIEWS / gen_s:.1f} views/s); "
          f"format {format_s:.2f} s; C++ engine on the train split: masks "
          f"{mask_s:.3f} s ({float(tr.train_dset.mask.float().mean()):.4f} kept), "
          f"pools {pools_s:.3f} s ({int(counts.min())}-{int(counts.max())} valid "
          f"pixels a view)")
    if tr.train_dset.ray_mode != "onthefly" or not tr.use_mask:
        raise AssertionError(f"real scan: ray_mode {tr.train_dset.ray_mode}, "
                             f"use_mask {tr.use_mask}")
    r = graphed_steps(tr, "real scan")
    launches, trace_counts, step_ms = r["launches"], r["trace_counts"], r["median_step_ms"]
    first, last = r["loss_first5"], r["loss_last5"]
    ev, eval_s = timed(lambda: tr.eval_step(tr.global_step, 0))
    if not np.isfinite(list(ev.values())).all():
        raise AssertionError(f"real scan: eval metrics not finite: {ev}")
    res = dict(
        views=r5.N_VIEWS, detector=[H, W], samples=r5.GEN_SAMPLES, generate_s=gen_s,
        views_per_s=r5.N_VIEWS / gen_s, format_s=format_s, mask_s=mask_s,
        pools_s=pools_s, native=native.available(), dataset_s=load_s,
        ray_mode=tr.train_dset.ray_mode, use_mask=tr.use_mask, n_rays=REAL_RAYS,
        steps=r["steps"], median_step_ms=step_ms,
        rays_per_s=REAL_RAYS / (step_ms / 1e3), loss_first5=first, loss_last5=last,
        eval=ev, eval_s=eval_s, launches=launches, trace_counts=trace_counts)
    print(f"e3 real scan: trainer with its in-memory train dataset in {load_s:.2f} s; "
          f"ray_mode {tr.train_dset.ray_mode}, use_mask {tr.use_mask}; "
          f"{r['steps']} steps of {REAL_RAYS} rays (under the profiler), median "
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
    rays = gather_view_batch(tr._arrays, int(tr._view_order(0)[0][0]), REAL_RAYS, g,
                             geo=ds.geo, near=ds.near, far=ds.far)["rays"]
    spec = tr.field.encoder.grid
    x01 = encoder_points(tr.field, rays, int(cfg["render"]["n_samples"]), g)
    sk, spf = sorted_stream(spec, x01)
    del tr, ds, rays
    torch.cuda.empty_cache()
    table = torch.randn((spec.num_levels, spec.table_size, spec.level_dim),
                        generator=g, device=dev)
    grads = torch.randn((spec.num_levels, spec.level_dim, sk.shape[1]),
                        generator=g, device=dev)
    hold_path_kernels(record, spec, sk, spf, table, grads, "table_real_scan",
                      "real_scan", plain_iters=3, x01=x01)
    for key, mode_key in REAL_MODES.items():
        entry_of(mode_key)["launches"] = int(launches.get(key, 0))
    return res



def graphed_steps(tr, where: str, steps: int = TRAIN_STEPS, needs=MAIN_NEEDS) -> dict:
    """``steps`` steps of ``tr`` through ``Trainer.train_steps`` (the
    graphed epoch function) under the profiler, with the launch counts set
    to 0 just before and read just after; fails unless the kernels of
    ``needs`` launched exactly as it says by the counts and by the trace,
    and the loss is finite and falling.  Returns the losses (a CPU tensor),
    the median step ms, the device ms a step and the counts."""
    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        StepTimer)
    views = tr._view_order(0)[:steps]
    torch.cuda.synchronize()
    _build.reset_launches()
    timer = StepTimer(tr.device)
    timer.tick()
    losses, dev_ms, trace_counts = traced(lambda: tr.train_steps(views, timer).cpu())
    launches = dict(_build.LAUNCHES)
    check_exact(where, launches, steps, needs)
    check_exact(f"{where} (profiler trace)", trace_counts, steps, needs)
    first, last = falling(where, losses.numpy(), 5)
    return dict(steps=steps, losses=losses, median_step_ms=float(np.median(timer.step_ms())),
                device_ms=dev_ms / steps, loss_first5=first, loss_last5=last,
                launches=launches, trace_counts=trace_counts)


def config_classes(dev, record, entry_of, smi: str) -> dict:
    """Phase (g): the configuration classes of the config-matrix scripts
    and of the chest datasets on the chest_50 model at full width; returns
    the ``configs`` JSON line's object."""
    import torch

    import config_matrix_converge_torch as converge
    import config_matrix_smoke_torch as smoke
    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        gather_view_batch, load_pickle)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import Trainer

    def trainer(name, cfg, i_eval=0):
        cfg["train"]["resume"] = False
        cfg["log"].update(i_eval=i_eval, i_save=0)
        return Trainer(cfg, workdir=os.path.join("logs", f"chip_smoke_{name}"), device=dev)

    def variant(name):
        return smoke.variant_cfg(converge.VARIANTS[name], f"chip_smoke_{name}",
                                 converge.data_path(name))

    def run(where, name, cfg, eager_too=False, i_eval=0):
        """``where``'s 20 graphed steps (and, with ``eager_too``, 20 eager
        ``train_step`` steps of a second trainer from the same seed, whose
        losses must be ``torch.equal``); peak memory from the trainer's
        creation on.  Returns the figures and the graphed trainer."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = trainer(name, cfg, i_eval)
        res = graphed_steps(tr, where)
        res["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
        n_rays = tr.n_rays * tr.n_batch
        res.update(n_rays=n_rays, n_samples=int(tr.cfg["render"]["n_samples"]),
                   rays_per_s=n_rays / (res["median_step_ms"] / 1e3))
        if eager_too:
            eager = trainer(f"{name}_eager", cfg)
            views = torch.as_tensor(eager._view_order(0)[:TRAIN_STEPS], device=dev)
            eager_losses = torch.stack([eager.train_step(v) for v in views]).cpu()
            del eager
            if not torch.equal(eager_losses, res["losses"]):
                raise AssertionError(f"{where}: the eager loop's losses differ from the "
                                     f"graphed steps': {eager_losses.tolist()} vs "
                                     f"{res['losses'].tolist()}")
            res["eager_losses_equal"] = True
        for kname in MAIN_NEEDS:
            entry_of(kname).setdefault("path_launches", {})[name] = \
                int(res["launches"].get(kname, 0))
        print(f"{where} ({smi}): {res['steps']} graphed steps of {n_rays} rays x "
              f"{res['n_samples']} samples (under the profiler), median "
              f"{res['median_step_ms']:.3f} ms, device {res['device_ms']:.3f} ms a "
              f"step, peak memory {res['peak_mb']:.1f} MB, {res['rays_per_s']:.0f} "
              f"rays/s, loss first-5 {res['loss_first5']:.6g} last-5 "
              f"{res['loss_last5']:.6g}"
              + (", 20 eager steps torch.equal" if eager_too else ""))
        print(f"{where}: launches {res['launches']}, kernels in the trace "
              f"{res['trace_counts']}")
        res["losses"] = res["losses"].tolist()
        return res, tr

    out = {}
    # g1. abdomen: 576 samples a ray, 589,824 points a level
    res, tr = run("g1 abdomen", "abdomen", variant("abdomen"))
    # the main path's kernels on one batch of this path, held against
    # their plain versions as phases 2-4 hold them
    g = torch.Generator(device=dev).manual_seed(1)
    rays = gather_view_batch(tr._arrays, 0, tr.n_rays, g)["rays"]
    spec = tr.field.encoder.grid
    x01 = encoder_points(tr.field, rays, res["n_samples"], g)
    sk, spf = sorted_stream(spec, x01)
    del tr, rays
    torch.cuda.empty_cache()
    table = torch.randn((spec.num_levels, spec.table_size, spec.level_dim),
                        generator=g, device=dev)
    grads = torch.randn((spec.num_levels, spec.level_dim, sk.shape[1]),
                        generator=g, device=dev)
    hold_path_kernels(record, spec, sk, spf, table, grads, "table_abdomen", "abdomen",
                      plain_iters=3, x01=x01)
    for key, mode_key in ABDOMEN_MODES.items():
        entry_of(mode_key)["launches"] = int(res["launches"].get(key, 0))
    res["points_a_level"] = int(sk.shape[1])
    out["abdomen"] = res
    del sk, spf, table, grads
    torch.cuda.empty_cache()

    # g2. foot: a tanh head, graphed against eager
    out["foot"], tr = run("g2 foot", "foot", variant("foot"), eager_too=True)
    del tr
    torch.cuda.empty_cache()

    # g3. jaw: no head activation, the beam mask from a 2-D full_proj, one eval
    full_proj = load_pickle(converge.data_path("jaw")).get("full_proj")
    if full_proj is None or np.ndim(full_proj) != 2:
        raise AssertionError("g3 jaw: the scan has no 2-D full_proj")
    res, tr = run("g3 jaw", "jaw", variant("jaw"), i_eval=1)
    if not tr.use_mask:
        raise AssertionError("g3 jaw: the trainer found no beam mask")
    ev, eval_s = timed(lambda: tr.eval_step(tr.global_step, 0))
    if not np.isfinite(list(ev.values())).all():
        raise AssertionError(f"g3 jaw: eval metrics not finite: {ev}")
    res.update(use_mask=True, mask_kept=float(tr.train_dset.mask.float().mean()),
               eval=ev, eval_s=eval_s)
    print(f"g3 jaw: use_mask True ({res['mask_kept']:.4f} of the pixels kept), eval "
          f"({eval_s:.2f} s): " + ", ".join(f"{k} {v:.4g}" for k, v in ev.items()))
    out["jaw"] = res
    del tr
    torch.cuda.empty_cache()

    # g4. the TV-D term under capture, graphed against eager
    out["tvd"], tr = run("g4 tvd", "tvd", load_config("configs/chest_phantom_tvd.yaml"),
                         eager_too=True)
    del tr
    torch.cuda.empty_cache()

    # g5. the chest datasets made on the card, then views200_b01
    out["chest_datasets"] = chest_datasets(dev)
    cfg = load_config("configs/chest_phantom_views200_b01.yaml")
    res, tr = run("g5 views200_b01", "views200_b01", cfg)
    if tr.train_dset.n_views != 200:
        raise AssertionError(f"g5: views200_b01 trains on {tr.train_dset.n_views} views")
    res["n_views"] = 200
    out["views200_b01"] = res
    del tr
    torch.cuda.empty_cache()
    return out


def chest_datasets(dev) -> dict:
    """g5: ``data/chest_phantom_smooth.pickle`` and
    ``data/chest_phantom_views{100,200}.pickle`` made on the card by the
    port's scripts, and the stored 50 views reprojected and held to the
    view sweep's rule."""
    import make_smooth_phantom_torch as smooth
    import make_view_sweep_data_torch as sweep
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        load_pickle)
    from neuralvolumetricreconstructionformedicalimages_torch.data.generate import save

    chest = load_pickle(sweep.SRC)
    res = {}
    data, wall = timed(lambda: smooth.smooth_phantom(chest, dev))
    save(data, smooth.OUT)
    res["smooth"] = dict(path=smooth.OUT, wall_s=wall,
                         views=len(data["train"]["angles"]) + len(data["val"]["angles"]))
    for n_views in sweep.VIEWS:
        data, wall = timed(lambda: sweep.view_sweep(chest, n_views, dev))
        save(data, sweep.out_path(n_views))
        res[f"views{n_views}"] = dict(path=sweep.out_path(n_views), wall_s=wall,
                                      views=n_views)
    del data
    proj, wall = timed(lambda: sweep.project_views(chest, chest["train"]["angles"], dev))
    res["reprojection_check"] = dict(wall_s=wall, **sweep.check_reprojection(chest, proj))
    print("g5 chest datasets: " + "; ".join(
        f"{k} {v['views']} views in {v['wall_s']:.2f} s" for k, v in res.items()
        if "views" in v) + f"; the stored 50 views reprojected: "
          f"{res['reprojection_check']}")
    return res


def real_scale_batches(dev, record, entry_of, smi: str) -> dict:
    """Phase (h): the real-scale smoke's path, the batch sweep, and the main
    path's kernels at 8,192 rays; returns the ``real_scale`` JSON line's
    object."""
    import torch

    import batch_sweep_torch as sweep
    import real_scale_smoke_torch as rs_smoke
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        gather_view_batch)
    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
    from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
        make_optimizer)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        build_model, make_epoch_fn)

    t_phase = time.perf_counter()
    out = {}
    # h1. scripts/real_scale_smoke_torch.py's path at full size: 187 random
    # views of 1024^2, rays on the fly, 4-step epochs of 1024 rays (a
    # warm-up epoch with the eager step and the capture, 2 timed)
    torch.cuda.synchronize()
    _build.reset_launches()
    rec, _, trace_counts = traced(lambda: rs_smoke.run(timed_epochs=2, device=dev))
    launches = dict(_build.LAUNCHES)
    steps = rs_smoke.STEPS * 3
    if rec["ray_mode"] != "onthefly":
        raise AssertionError(f"h1: ray_mode {rec['ray_mode']}")
    if len(rec["losses"]) != steps or not np.isfinite(rec["losses"]).all():
        raise AssertionError(f"h1: bad losses {rec['losses']}")
    check_exact("h1 real-scale smoke", launches, steps)
    check_exact("h1 real-scale smoke (profiler trace)", trace_counts, steps)
    rec.update(launches=launches, trace_counts=trace_counts)
    print(f"h1 real-scale smoke ({smi}): {rec['views']} views of {rec['detector']}, "
          f"ray_mode {rec['ray_mode']} ({rec['ray_tensor_avoided_gib']:.1f} GiB of rays "
          f"avoided), dataset {rec['dataset_s']:.1f} s, warm-up {rec['warm_s']:.2f} s, "
          f"{rec['ms_per_step']:.3f} ms a step (under the profiler), {rec['rays_s']:.0f} "
          f"rays/s, peak allocated {rec['peak_allocated_mb']:.1f} MB; launches "
          f"{launches}, kernels in the trace {trace_counts}")
    for kname in MAIN_NEEDS:
        entry_of(kname).setdefault("path_launches", {})["real_scale_smoke"] = \
            int(launches.get(kname, 0))
    out["h1"] = rec
    torch.cuda.empty_cache()

    # h2. scripts/batch_sweep_torch.py, each configuration in a process of
    # its own; every figure of its records finite, each harness's kernels
    # once a step
    proc, wall = timed(lambda: subprocess.run(
        [sys.executable, "scripts/batch_sweep_torch.py", *SWEEP_ARGS, "--out",
         os.path.join("logs", "chip_smoke_batch_sweep.md")],
        capture_output=True, text=True, timeout=600))
    if proc.returncode != 0:
        raise AssertionError(f"h2: the batch sweep failed ({proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    recs = [json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
            if line.startswith("SWEEPREC ")]
    if [r["n_rays"] for r in recs] != [int(b) for b in SWEEP_ARGS[1].split(",")]:
        raise AssertionError(f"h2: records of {[r['n_rays'] for r in recs]}")
    for r in recs:
        figures = [v for v in r.values() if isinstance(v, (int, float))]
        figures += [x for v in r.values() if isinstance(v, list) for x in v]
        if not np.isfinite(figures).all():
            raise AssertionError(f"h2: a figure is not finite: {r}")
        check_exact(f"h2 {r['n_rays']} rays (timed epochs)", r["launches"],
                    r["timed_epoch_steps"])
        check_exact(f"h2 {r['n_rays']} rays (timed iso blocks)", r["iso_launches"],
                    r["timed_epoch_steps"])
        print(f"h2 batch sweep ({smi}), {r['n_rays']} rays, {r['table_dtype']} table: "
              f"epoch {r['epoch_ms']:.3f} ms ({r['epoch_rays_s']:.0f} rays/s, device "
              f"{r['epoch_device_ms']:.3f} ms), iso {r['iso_ms']:.3f} ms "
              f"({r['iso_rays_s']:.0f} rays/s, device {r['iso_device_ms']:.3f} ms), "
              f"warm-up {r['warm_s']:.2f} s, peak {r['peak_mb']:.1f} MB")
    out["h2"] = {"args": SWEEP_ARGS, "wall_s": wall, "records": recs}

    # h3. the 8,192-ray step in this process: BATCH_STEPS graphed steps on
    # the sweep's scan (the table mode, the bucket and the unroll exactly
    # once a step: the forward is not chunked), then the three kernels held
    # against their plain versions on one batch of it (1,572,864 sorted
    # points a level)
    cfg = sweep.sweep_cfg(BATCH_RAYS, "bfloat16")
    arrays = sweep.scan_arrays(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    field = build_model(cfg, g, dev)
    epoch_fn = make_epoch_fn(cfg, field, make_optimizer(cfg, field.parameters()),
                             BATCH_STEPS, n_rays=BATCH_RAYS, n_batch=1, use_mask=False,
                             generator=g)
    order = torch.arange(BATCH_STEPS, device=dev)[:, None]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, dev_ms, trace_counts = traced(lambda: epoch_fn(arrays, order, 0).cpu())
    launches = dict(_build.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    if not torch.isfinite(losses).all():
        raise AssertionError(f"h3: bad losses {losses.tolist()}")
    check_exact("h3 8192 rays", launches, BATCH_STEPS)
    check_exact("h3 8192 rays (profiler trace)", trace_counts, BATCH_STEPS)
    print(f"h3 {BATCH_RAYS} rays ({smi}): {BATCH_STEPS} steps (one eager, a capture, "
          f"replays; under the profiler), device {dev_ms / BATCH_STEPS:.3f} ms a step, "
          f"peak {peak_mb:.1f} MB, losses {losses.tolist()}, launches {launches}, "
          f"kernels in the trace {trace_counts}")
    gk = torch.Generator(device=dev).manual_seed(2)
    rays = gather_view_batch(arrays, 0, BATCH_RAYS, gk)["rays"]
    spec = field.encoder.grid
    x01 = encoder_points(field, rays, sweep.N_SAMPLES, gk)
    sk, spf = sorted_stream(spec, x01)
    del epoch_fn, field, arrays, rays
    torch.cuda.empty_cache()
    table = torch.randn((spec.num_levels, spec.table_size, spec.level_dim),
                        generator=gk, device=dev)
    grads = torch.randn((spec.num_levels, spec.level_dim, sk.shape[1]),
                        generator=gk, device=dev)
    hold_path_kernels(record, spec, sk, spf, table, grads, "table_batch8192",
                      "batch8192", plain_iters=3, x01=x01)
    for key, mode_key in BATCH_MODES.items():
        entry_of(mode_key)["launches"] = int(launches.get(key, 0))
    out["h3"] = dict(n_rays=BATCH_RAYS, steps=BATCH_STEPS, points_a_level=int(sk.shape[1]),
                     losses=losses.tolist(), device_ms=dev_ms / BATCH_STEPS,
                     peak_mb=peak_mb, launches=launches, trace_counts=trace_counts)
    del sk, spf, table, grads
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase h (h1-h3) in {out['wall_s']:.1f} s")
    return out


def verify_drive(dev, record, entry_of, smi: str) -> dict:
    """i1: ``scripts/verify_drive_torch.py``'s drive whole, then the main
    path's kernels at its shape."""
    import torch

    import verify_drive_torch as vd
    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build

    # i1. 35 blocks of 100 graphed steps (the first block, with the eager
    # step and the capture, under the profiler), then the eval under the
    # JAX script's thresholds
    drive = vd.Drive(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    _, dev_ms, trace_counts = traced(drive.block)
    drive.train(log=lambda m: None)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    steps = drive.steps_done
    if steps != vd.BLOCKS * vd.BLOCK_STEPS:
        raise AssertionError(f"i1: the drive ran {steps} steps")
    check_exact("i1 verify drive", launches, steps)
    check_exact("i1 verify drive, first block (profiler trace)", trace_counts,
                vd.BLOCK_STEPS)
    ev, eval_s = timed(drive.evaluate)
    print(f"i1 verify drive ({smi}): {steps} steps, {drive.ms_per_step():.3f} ms a step "
          f"(median block), first block {drive.blocks[0]['wall_s']:.2f} s (device "
          f"{dev_ms / vd.BLOCK_STEPS:.3f} ms a step, under the profiler); loss "
          f"{drive.blocks[0]['loss']:.3e} -> {drive.blocks[-1]['loss']:.3e}; launches "
          f"{launches}, first block's trace {trace_counts}")
    print(f"i1 proj PSNR: {ev['proj_psnr']:.1f} dB  mean sigma inside={ev['inside']:.3f} "
          f"outside={ev['outside']:.3f} (eval {eval_s:.2f} s)")
    print("VERIFY", "PASS" if ev["ok"] else "FAIL")
    if not ev["ok"]:
        raise AssertionError(f"i1: the verify drive failed the JAX thresholds: {ev}")
    res = dict(steps=steps, ms_per_step=drive.ms_per_step(), blocks=drive.blocks,
               first_block_device_ms=dev_ms / vd.BLOCK_STEPS, eval=ev, eval_s=eval_s,
               launches=launches, trace_counts_first_block=trace_counts)

    # the three kernels at the drive's shape: one batch of 1024 rays x 96
    # samples (98,304 sorted points a level, 8 levels of 2^15), the f32
    # table the drive trained
    g = torch.Generator(device=dev).manual_seed(3)
    idx = vd.draw_indices(g, drive.arrays["rays"].shape[0], 1, dev)[0]
    spec = drive.field.encoder.grid
    x01 = encoder_points(drive.field, drive.arrays["rays"][idx], vd.N_SAMPLES, g)
    sk, spf = sorted_stream(spec, x01)
    table = drive.field.table.detach().clone()
    grads = torch.randn((spec.num_levels, spec.level_dim, sk.shape[1]), generator=g,
                        device=dev)
    del drive
    hold_path_kernels(record, spec, sk, spf, table, grads, "table_verify", "verify",
                      plain_iters=3, table_dtype=torch.float32, x01=x01)
    for key, mode_key in VERIFY_MODES.items():
        entry_of(mode_key)["launches"] = int(launches.get(key, 0))
    res["points_a_level"] = int(sk.shape[1])
    return res


def resume_across_configs(dev) -> dict:
    """i2: chest_phantom_r3 for two epochs with a checkpoint at each, then
    a consolidate-shaped and a finetune-shaped resume of it, each graphed
    against an eager resume from the same checkpoint."""
    import shutil

    import torch

    from neuralvolumetricreconstructionformedicalimages_torch.config import load_config
    from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import Trainer

    workdir = os.path.join("logs", "chip_smoke_resume")
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = load_config("configs/chest_phantom_r3.yaml")
    cfg["train"]["epoch"] = 1                  # epochs 0 and 1
    cfg["log"].update(i_eval=0, i_save=1)      # a checkpoint at epoch 1
    tr = Trainer(cfg, workdir=workdir, device="cuda")
    tr.start()
    steps_per_epoch = tr.steps_per_epoch
    del tr
    out = {}
    # each resume runs one more epoch under its own StepLR period (RESUMES)
    for name, epoch, lrate_step in RESUMES:
        cfg = load_config(f"configs/chest_phantom_{name}.yaml")
        cfg["train"].update(epoch=epoch, lrate_step=lrate_step)
        cfg["log"].update(i_eval=0, i_save=1)
        eager = Trainer(cfg, workdir=workdir, device="cuda")    # both restore epoch - 1
        graphed = Trainer(cfg, workdir=workdir, device="cuda")
        start_step = epoch * steps_per_epoch
        for t in (eager, graphed):
            if (t.epoch_start, t.global_step) != (epoch, start_step):
                raise AssertionError(f"i2 {name}: resumed at epoch {t.epoch_start}, "
                                     f"step {t.global_step}")
        train = cfg["train"]
        want_lr = float(train["lrate"]) * float(train["lrate_gamma"]) ** (
            epoch // lrate_step)
        torch.cuda.synchronize()
        _build.reset_launches()
        _, _, trace_counts = traced(graphed.start)
        launches = dict(_build.LAUNCHES)
        check_exact(f"i2 {name}", launches, steps_per_epoch)
        check_exact(f"i2 {name} (profiler trace)", trace_counts, steps_per_epoch)
        lr = graphed.optimizer.param_groups[0]["lr"]
        if not (isinstance(lr, torch.Tensor) and lr.device.type == "cuda"
                and torch.equal(lr, torch.tensor(want_lr, device=lr.device))
                and graphed.schedule(start_step) == want_lr):
            raise AssertionError(f"i2 {name}: the rate after the resume is {lr}, the "
                                 f"new config's schedule gives {want_lr}")
        steps = [st["step"] for st in graphed.optimizer.state.values()]
        if not all(s.device.type == "cuda" and float(s) == start_step + steps_per_epoch
                   for s in steps):
            raise AssertionError(f"i2 {name}: Adam's step counts {steps[:3]}...")
        order = torch.as_tensor(eager._view_order(epoch), device=dev)
        eager_losses = torch.stack([eager.train_step(v) for v in order]).cpu()
        if not torch.equal(eager_losses, torch.tensor(graphed.losses)):
            raise AssertionError(f"i2 {name}: the graphed losses differ from the eager "
                                 f"resume's: {graphed.losses} vs {eager_losses.tolist()}")
        n_samples = int(graphed.cfg["render"]["n_samples"])
        out[name] = dict(epoch=epoch, start_step=start_step, lr=want_lr,
                         n_samples=n_samples, losses=list(graphed.losses),
                         launches=launches, trace_counts=trace_counts)
        print(f"i2 {name}: resumed at epoch {epoch} (step {start_step}), rate "
              f"{float(lr):.3g} on the card (schedule {want_lr:.3g}), Adam's steps on "
              f"the card at {start_step + steps_per_epoch}, {n_samples} samples; "
              f"{len(graphed.losses)} graphed losses torch.equal to the eager resume's; "
              f"launches {launches}, kernels in the trace {trace_counts}")
        del eager, graphed
        torch.cuda.empty_cache()
    return out


def remaining_scripts(dev, record, entry_of, smi: str) -> dict:
    """Phase (i): the verify drive, resume across configs and the
    multi-process scripts; returns the ``scripts`` JSON line's object."""
    import torch

    import multiprocess_smoke_torch as mps
    import scaling_sweep_torch as sweep
    import shard_overhead_torch as so

    t_phase = time.perf_counter()
    out = {"i1": verify_drive(dev, record, entry_of, smi)}
    torch.cuda.empty_cache()
    out["i2"] = resume_across_configs(dev)

    # i3. two gloo ranks sharing cuda:0 through initialize_multihost on a
    # free port: identical parameter digests after two sharded steps
    res = mps.smoke("cuda", port=mps.free_port())
    if not res["ok"]:
        raise AssertionError(f"i3: the ranks' digests differ: {res['ranks']}")
    print(f"i3 multi-process smoke: {len(res['ranks'])} gloo ranks on cuda:0 in "
          f"{res['wall_s']:.1f} s, identical params_sha256 "
          f"{res['ranks'][0]['params_sha256'][:16]}...")
    out["i3"] = res

    # i4. the mesh-of-one overhead and the gradient all-reduce
    rec = so.run(dev, steps=so.STEPS)
    figures = [rec["plain"]["ms_per_step"], rec["mesh1"]["ms_per_step"],
               rec["mesh1_eager"]["ms_per_step"],
               rec["allreduce_1rank_ms"], rec["allreduce_2rank_gloo_ms"]]
    if not np.isfinite(figures).all():
        raise AssertionError(f"i4: a figure is not finite: {rec}")
    if not rec["mesh1_graphed"]:
        raise AssertionError(f"i4: the mesh of one was not graphed ({rec['backend_1rank']})")
    print(f"i4 shard overhead ({smi}): plain graphed {rec['plain']['ms_per_step']:.3f} ms "
          f"a step, mesh of one graphed ({rec['backend_1rank']}) "
          f"{rec['mesh1']['ms_per_step']:.3f} ms ({rec['mesh1']['overhead_ms']:+.3f}), "
          f"eager {rec['mesh1_eager']['ms_per_step']:.3f} ms "
          f"({rec['mesh1_eager']['overhead_ms']:+.3f}); all-reduce of "
          f"{rec['payload_mib']:.1f} MiB: {rec['allreduce_1rank_ms']:.3f} ms one rank, "
          f"{rec['allreduce_2rank_gloo_ms']:.3f} ms two gloo ranks")
    out["i4"] = rec
    torch.cuda.empty_cache()

    # i5. the scaling sweep at 1 and 2 ranks sharing cuda:0
    rows = sweep.sweep("cuda", SWEEP_RANKS, 1024, 64, 15, 8, "take")
    if not np.isfinite([r["rays_per_s"] for r in rows]).all():
        raise AssertionError(f"i5: {rows}")
    print(f"i5 scaling sweep ({smi}), ranks sharing cuda:0: {rows}")
    out["i5"] = rows
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase i (i1-i5) in {out['wall_s']:.1f} s")
    return out


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
    from shard_overhead_torch import allreduce_ms

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
            res["allreduce_ms"] = allreduce_ms(
                sum(p.numel() for p in tr.field.parameters()), tr.device)
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
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        traced_device_ms)
    from shard_overhead_torch import allreduce_ms

    # f1. a mesh of one on a one-rank NCCL group the trainer makes itself:
    # Trainer.start runs the graphed sharded epoch (one eager step, one
    # capture, 49 replays)
    cfg = load_config(cfg_path)
    cfg["parallel"] = {"mesh": {"data": 1, "sample": 1}, "force_mesh": True}
    cfg["train"]["epoch"] = 0       # one epoch: 50 views -> 50 steps
    cfg["log"].update(i_eval=0, i_save=0)   # the eval draws nothing
    f1_needs = dict(MAIN_NEEDS, all_reduce_grads=True)
    tr = Trainer(cfg, workdir=os.path.join("logs", "chip_smoke_f1"), device="cuda")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        _, _, trace, _ = traced_device_ms(tr.start)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e6
        launches = dict(_build.LAUNCHES)
        backend = dist.get_backend()
        graph = tr._epoch_fn.graphed.graph
        if graph is None:
            raise AssertionError("f1: the sharded epoch captured no graph")
        trace_counts = {}
        for kname, (_, n) in trace.items():
            key = _launch_key(kname)
            if key:
                trace_counts[key] = trace_counts.get(key, 0) + n
        # NCCL's device work in the trace: an in-place sum on one rank may
        # launch none (the replay-aware count shows the all-reduce)
        nccl = {k: n for k, (_, n) in trace.items() if "nccl" in k.lower()}
        check_exact("f1", launches, 50, f1_needs)
        check_exact("f1 (profiler trace)", trace_counts, 50)
        order = torch.as_tensor(tr._view_order(0), device=tr.device)
        # 5 more replayed steps: any host sync raises
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tr.train_steps(order[:5])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if tr._epoch_fn.graphed.graph is not graph:
            raise AssertionError("f1: the sharded step was captured again")
        graphed_nums = epoch_numbers(tr, order, graphed=True)
        ar_ms = allreduce_ms(sum(p.numel() for p in tr.field.parameters()), tr.device)
    finally:
        tr.close()
    losses, step_ms = torch.tensor(tr.losses), float(np.median(tr.step_ms))
    if not torch.equal(losses, torch.tensor(main_losses)):
        raise AssertionError(f"f1: the force_mesh losses differ from phase 4's: "
                             f"{tr.losses} vs {main_losses}")
    del tr
    torch.cuda.empty_cache()
    # the same epoch through the mesh's eager train_step loop, from the seed
    eager = Trainer(cfg, workdir=os.path.join("logs", "chip_smoke_f1_eager"), device="cuda")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eager_losses = torch.stack([eager.train_step(v) for v in order]).cpu()
        eager_peak = torch.cuda.max_memory_allocated() / 1e6
        eager_nums = epoch_numbers(eager, order, graphed=False)
    finally:
        eager.close()
    if not torch.equal(eager_losses, losses):
        bad = int((eager_losses != losses).sum())
        raise AssertionError(f"f1: the eager sharded loop's losses differ from the "
                             f"graphed epoch's at {bad} of 50 steps")
    del eager
    torch.cuda.empty_cache()
    graphed_nums.update(peak_mb_first_epoch=peak, host_syncs_per_replayed_step=0)
    eager_nums["peak_mb_first_epoch"] = eager_peak
    f1 = dict(config=cfg_path, mesh=cfg["parallel"], backend=backend,
              steps=len(losses), wall_s=wall, allreduce_ms=ar_ms,
              median_step_ms=step_ms, losses=losses.tolist(), losses_equal_phase4=True,
              losses_equal_eager_sharded=True, launches=launches,
              trace_counts=trace_counts, nccl_in_trace=nccl,
              graphed=graphed_nums, eager=eager_nums)
    print(f"f1 force_mesh ({backend}, one rank, graphed): {len(losses)} steps in "
          f"{wall:.1f} s (under the profiler), losses torch.equal to phase 4's and to the "
          f"eager sharded loop's, launches {launches}, kernels in the trace "
          f"{trace_counts}, NCCL work in the trace {nccl}; gradient all-reduce "
          f"{ar_ms:.3f} ms; host syncs in 5 replayed steps: 0")
    for mode, m in (("graphed", graphed_nums), ("eager", eager_nums)):
        print(f"f1 mesh of one, {mode} ({smi}): median {m['median_step_ms']:.3f} ms a "
              f"step, device {m['device_ms']:.3f} ms a step, idle share "
              f"{m['idle_share']:.3f}, peak memory {m['peak_mb_first_epoch']:.1f} MB, "
              f"reserved {m['reserved_mb']:.1f} MB")

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
        _indices_weights_frac_plain, hash_grid_indices, sorted_corner_stream,
        sorted_corner_stream_plain, xor_index)
    from neuralvolumetricreconstructionformedicalimages_torch.train.trainer import (
        Trainer, build_model, pin_fp32)
    from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (
        device_times, time_fn)
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
    # bound: keys, packed fracs and output, and each distinct key's F bf16
    # values, each read once.  Beside it, the 32-byte sectors of the rolled
    # table that hold some key's column, in each of its F rows: a key's F
    # values lie in F rows S columns apart, so the card fetches a whole
    # sector of each, and that is what sets the mode's time.
    distinct, _, sec_rolled, _ = stream_counts(spec, sk)
    io = L * B * 4 * 2 + L * C * B * 4
    n_ops = L * B * (K * D + 2 * K * C)
    print(f"span_gather_sorted (rolled): bound {bound_ms(io + distinct * F * 2, n_ops)[0]:.4f} "
          f"ms ({distinct} distinct keys x {F} x 2 bytes, {distinct * F * 2 / 1e6:.1f} MB); "
          f"the 32-byte sectors that hold them take "
          f"{bound_ms(io + sec_rolled * F * 32, n_ops)[0]:.4f} ms ({sec_rolled * F} "
          f"sectors, {sec_rolled * F * 32 / 1e6:.1f} MB)")
    record("span_gather_sorted", err,
           lambda: sg.span_gather_sorted(sk, spf, R, input_dim=D),
           lambda: sg.span_gather_sorted_plain(sk, spf, R, input_dim=D), None,
           io + distinct * F * 2, n_ops)
    del R, out, out_plain

    # ---- 2-4. the main path's kernels on its batch: the span gather's
    # table mode, the bucket and the unroll ----
    hold_path_kernels(record, spec, sk, spf, table, grads, "table", None, x01=x01)
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
           lambda: rk.unroll_reduce_fm_plain(h1, spec, C),
           unroll_index_add_call(h1, spec, C),
           L * F * S * 2 + L * S * C * 4, L * S * C * (K - 1), mode="bf16_in")
    del h1, u
    # the XOR path's index kernel on the same points: idx, w and frac
    # torch.equal to its plain version
    xi, xp = xor_index(spec, x01), _indices_weights_frac_plain(spec, x01)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(xi, xp)):
        raise AssertionError("xor_index is not bit-equal to its plain version")
    del xi, xp
    # bound: the points read once; idx and w [B, L, 8], frac [B, L, 3]
    # written once
    record("xor_index", 0.0, lambda: xor_index(spec, x01),
           lambda: _indices_weights_frac_plain(spec, x01), None,
           B * D * 4 + B * L * (K * 4 * 2 + D * 4), 0, plain_iters=3)
    # the XOR backward's corner sort on the same points: sk and sg
    # torch.equal to its plain version
    xidx, xw = hash_grid_indices(spec, x01)
    xg = grads.permute(2, 0, 1)
    xsk, xsg = sorted_corner_stream(xidx, xw, xg, S)
    psk, psg = sorted_corner_stream_plain(xidx, xw, xg)
    torch.cuda.synchronize()
    if not (torch.equal(xsk, psk) and torch.equal(xsg, psg)):
        raise AssertionError("sorted_corner_stream is not bit-equal to its plain version")
    del psk, psg
    # the library call: torch.sort of the transposed keys and the gather of
    # a ready payload, the plain version's two calls
    NX = B * K
    xkeys = xidx.permute(1, 0, 2).reshape(L, NX)
    xpay = (xw[..., None] * xg[:, :, None, :]).permute(1, 3, 0, 2).reshape(L, C, NX)

    def sort_and_gather():
        _, perm = torch.sort(xkeys, dim=-1, stable=True)
        return torch.gather(xpay, 2, perm[:, None, :].expand(L, C, NX))

    # bound: idx, w and g read once, sk and sg written once
    record("xor_corner_sort", 0.0, lambda: sorted_corner_stream(xidx, xw, xg, S),
           lambda: sorted_corner_stream_plain(xidx, xw, xg), sort_and_gather,
           B * L * (K * 4 * 2 + C * 4) + L * NX * (4 + C * 4), 0, plain_iters=3)
    del xidx, xw, xg, xkeys, xpay
    # bucket at D=0 on that stream (the XOR backward)
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
    # the in-order sum is the plain version on a CPU copy (on the card
    # index_add_ adds with atomics, in no fixed order)
    NS = B * K
    sidx = torch.randint(0, S, (NS,), generator=gen, device=dev, dtype=torch.int32)
    spay = torch.randn((NS, C), generator=gen, device=dev)
    hidx = sidx.clone()
    hidx[:700] = 4321                              # one 700-update column
    rows = sl.scatter_plan(NS, S, C).rows
    oidx = torch.randint(7 * rows, 8 * rows, (NS,), generator=gen, device=dev,
                         dtype=torch.int32)        # every update in one slab
    s_err = {}
    for mode, ix in ((None, sidx), ("hot_row", hidx), ("one_slab", oidx)):
        s1, s2 = sl.scatter_level(ix, spay, S), sl.scatter_level(ix, spay, S)
        torch.cuda.synchronize()
        want = sl.scatter_level_plain(ix.cpu(), spay.cpu(), S)
        if not torch.equal(s1, s2):
            raise AssertionError(f"scatter_level ({mode}) is not bit-identical "
                                 f"across launches")
        s_err[mode] = float((s1.cpu() - want).abs().max())
        if not torch.equal(s1.cpu(), want):
            raise AssertionError(f"scatter_level ({mode}) differs from the "
                                 f"in-order sum by {s_err[mode]}")
    print("scatter_level: torch.equal to the in-order sum (uniform, a 700-update "
          "column, one slab), bit-identical across launches")
    for mode, ix in ((None, sidx), ("hot_row", hidx), ("one_slab", oidx)):
        record("scatter_level", s_err[mode],
               lambda ix=ix: sl.scatter_level(ix, spay, S),
               lambda ix=ix: sl.scatter_level_plain(ix, spay, S),
               lambda ix=ix: torch.zeros((S, C), device=dev).index_add_(
                   0, ix, spay),
               NS * (4 + 4 * C) + S * C * 4, NS * C, mode=mode,
               plain_iters=20 if mode is None else 3)
    results["scatter_level"]["against_library"] = scatter_against_library(
        lambda: sl.scatter_level(sidx, spay, S),
        lambda: torch.zeros((S, C), device=dev).index_add_(0, sidx, spay))
    del s1, s2, want, sidx, hidx, oidx, spay, sk, spf, sf
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
    for mode in ("hot_row", "one_slab"):   # skewed streams: no path runs them
        results["scatter_level"]["modes"][mode]["launches"] = 0
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
        r = graphed_steps(tr, f"{pname} path", needs=need)
        plaunch, pmed = r["launches"], r["median_step_ms"]
        paths[pname] = dict(encoder=enc_over, steps=r["steps"], median_step_ms=pmed,
                            rays_per_s=n_rays / (pmed / 1e3), loss_first5=r["loss_first5"],
                            loss_last5=r["loss_last5"], launches=plaunch,
                            trace_counts=r["trace_counts"])
        print(f"path {pname}: {r['steps']} steps (under the profiler), median "
              f"{pmed:.3f} ms, {n_rays / (pmed / 1e3):.0f} rays/s, loss first-5 "
              f"{r['loss_first5']:.6g} last-5 {r['loss_last5']:.6g}, launches {plaunch}, "
              f"kernels in the trace {r['trace_counts']}")
        for kname, mode in (("bucket_grad_matmul", {"xor": "xor_d0", "rolled": "bf16_out"}),
                            ("unroll_reduce_fm", {"rolled": "bf16_in"})):
            if pname in mode:
                results[kname]["modes"][mode[pname]]["launches"] = \
                    int(plaunch.get(kname, 0))
        if pname == "rolled":   # the roll build's path since the main path skips it
            results["roll_broadcast_fm"]["launches"] = int(plaunch["roll_broadcast_fm"])
        if pname == "xor":
            results["xor_index"]["launches"] = int(plaunch["xor_index"])
            results["xor_corner_sort"]["launches"] = int(plaunch["xor_corner_sort"])
        del tr
        torch.cuda.empty_cache()

    # ---- g. the configuration classes on the card ----
    configs_line = config_classes(dev, record, entry_of, smi)
    torch.cuda.empty_cache()

    # ---- h. the real scan at scale and the batch sweep ----
    real_scale_line = real_scale_batches(dev, record, entry_of, smi)
    torch.cuda.empty_cache()

    # ---- i. the verify drive, resume across configs, the multi-process
    # scripts ----
    scripts_line = remaining_scripts(dev, record, entry_of, smi)
    torch.cuda.empty_cache()

    line = []
    for r in results.values():
        for entry in (r, *r.get("modes", {}).values()):
            entry["max_err"] = entry["max_abs_err"]
            entry["kernel_ms"] = entry["ms"]
        line.append(r)
    print(json.dumps({"data": data_line, "card": smi}))
    print(json.dumps({"parallel": parallel_line}))
    print(json.dumps({"configs": configs_line, "card": smi}))
    print(json.dumps({"real_scale": real_scale_line, "card": smi}))
    print(json.dumps({"scripts": scripts_line, "card": smi}))
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
