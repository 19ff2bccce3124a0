#!/usr/bin/env python3
"""Where the in-order scatter kernel's device time goes, phase by phase.

Builds ``csrc/scatter_level.cu`` and variants of it that each cut one phase
of the accumulate kernel (by replacing a line of its source; a replaced
line that is no longer in the source stops the script), each with two
extra C entries that launch the partition alone and the accumulate alone.
Then, at the encoder microbenchmark's shape (N = 1,572,864 uniform
updates into S = 2^19 rows, C = 2), it times on the card, back to back
between one pair of CUDA events (200 calls, the host ahead of the card):
the partition alone, the accumulate alone (on the partition's output) and
the whole kernel (the C entry that ``ops/scatter_level.py`` calls, both
kernels).  A cut variant computes a wrong table, so only the whole kernel
is held against the in-order sum (the plain version on a CPU copy).

Variants: ``whole``; ``no_adds`` (each warp's in-order adds cut);
``no_gather`` (the payloads not read); ``no_chunks`` (the window prologue
only: the tiles' offsets scanned, no update loaded); ``no_window`` (the
zero fill of the accumulators and the write-out only).

Run from the repository root on a machine with the card and nvcc:

    python3 scripts/scatter_phases_torch.py [--out PATH.json]

Prints one line a variant and the card's name and power limit; writes the
numbers as JSON to ``--out`` if given.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from neuralvolumetricreconstructionformedicalimages_torch.ops import _build  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import scatter_level as sl  # noqa: E402

N, S, C = 1_572_864, 1 << 19, 2

# C entries appended to each variant: the partition alone and the
# accumulate alone, for C = 2 and 4-byte staged words (this shape's plan)
ENTRIES = r'''
extern "C" int phase_partition(const void* idx, void* ws, long long N,
                               long long S, void* stream) {
  const Plan p = make_plan(2, N, S);
  unsigned* stage = reinterpret_cast<unsigned*>(ws);
  cudaError_t e = allow_shared_memory<2, unsigned>();
  if (e != cudaSuccess || p.wide) return (int)cudaErrorInvalidValue;
  scatter_partition_kernel<unsigned><<<(unsigned)p.n_tiles, kPartThreads,
      partition_smem<unsigned>(p.n_slabs), (cudaStream_t)stream>>>(
      (const int*)idx, stage, reinterpret_cast<int*>(stage + N), N, S,
      p.rows_log2 + p.windows_log2, (int)p.n_slabs);
  return (int)cudaGetLastError();
}

extern "C" int phase_accumulate(const void* pay, void* out, void* ws,
                                long long N, long long S, void* stream) {
  const Plan p = make_plan(2, N, S);
  unsigned* stage = reinterpret_cast<unsigned*>(ws);
  cudaError_t e = allow_shared_memory<2, unsigned>();
  if (e != cudaSuccess || p.wide) return (int)cudaErrorInvalidValue;
  scatter_kernel<2, unsigned><<<dim3((unsigned)p.n_slabs, 1u << p.windows_log2),
      kAccThreads, accumulate_smem<2>(), (cudaStream_t)stream>>>(
      (const float*)pay, stage, reinterpret_cast<const int*>(stage + N),
      (float*)out, S, p.windows_log2, (int)p.n_slabs, p.n_tiles);
  return (int)cudaGetLastError();
}
'''

VARIANTS = {
    "whole": [],
    "no_adds": [("for (int b = beg; b < end; b += 32) {",
                 "for (int b = beg; b < beg; b += 32) {")],
    "no_gather": [("v[k] = pv[(t0 + lo[k]) * kTile + (long long)(word[k] >> kHalf)];",
                   "v[k] = Vec<C>::zero();")],
    "no_chunks": [("for (int q0 = 0; q0 < total; q0 += kChunk) {",
                   "for (int q0 = 0; q0 < 0; q0 += kChunk) {")],
    "no_window": [("for (long long t0 = 0; t0 < n_tiles; t0 += kWinTiles) {",
                   "for (long long t0 = 0; t0 < 0; t0 += kWinTiles) {")],
}


def build(out_dir: str):
    """One shared library a variant, all nvcc processes at once."""
    src = (_build.CSRC / "scatter_level.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text + ENTRIES)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out.decode()}")
        libs[name] = ctypes.CDLL(so)
    return libs


def back_to_back_ms(fn, calls: int = 200) -> float:
    if fn() != 0:
        raise RuntimeError("a launch failed")
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scatter_phases_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build(os.path.join(ROOT, "build", "scatter_phases"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    idx = torch.randint(0, S, (N,), generator=gen, device=dev, dtype=torch.int32)
    pay = torch.randn((N, C), generator=gen, device=dev)
    plan = sl.scatter_plan(N, S, C)
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty((S, C), device=dev)
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    P, L = ctypes.c_void_p, ctypes.c_longlong
    want = sl.scatter_level_plain(idx.cpu(), pay.cpu(), S)
    rows = {name: {"partition_ms": [], "accumulate_ms": [], "both_ms": []}
            for name in libs}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            def part(lib=lib):
                return lib.phase_partition(P(idx.data_ptr()), P(ws.data_ptr()),
                                           L(N), L(S), st)

            def acc(lib=lib):
                return lib.phase_accumulate(P(pay.data_ptr()), P(out.data_ptr()),
                                            P(ws.data_ptr()), L(N), L(S), st)

            def both(lib=lib):
                return lib.nvr_scatter_level(
                    P(idx.data_ptr()), P(pay.data_ptr()), P(out.data_ptr()),
                    P(ws.data_ptr()), C, L(N), L(S), L(plan.ws_bytes), st)

            r = rows[name]
            r["partition_ms"].append(back_to_back_ms(part))
            r["accumulate_ms"].append(back_to_back_ms(acc))   # on part's output
            r["both_ms"].append(back_to_back_ms(both))
            if name == "whole":
                torch.cuda.synchronize()
                if not torch.equal(out.cpu(), want):
                    raise AssertionError("the whole kernel differs from the "
                                         "in-order sum")
    for name, r in rows.items():
        print(f"{name:10s} partition {' '.join('%.4f' % t for t in r['partition_ms'])}"
              f"  accumulate {' '.join('%.4f' % t for t in r['accumulate_ms'])}"
              f"  both {' '.join('%.4f' % t for t in r['both_ms'])} ms")
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "N": N, "S": S, "C": C, "variants": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
