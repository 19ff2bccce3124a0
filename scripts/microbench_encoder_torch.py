#!/usr/bin/env python3
"""Microbenchmarks of the hash encoder's gather/scatter primitives, PyTorch port.

Port of ``scripts/microbench_encoder.py``, bench for bench and with the
same ``--only`` names.  It times, in isolation, the strategies between
which the encoder's design chose: the corner gather (forward), its
autograd scatter and ``index_add_`` (backward), per-level sorts with
payload gathers, the sorted segment sum, a bf16 one-hot product and the
direct scatter kernel ``ops/scatter_level.py`` (the Pallas serial scatter
of the JAX script).

Workload constants (chest_50 scale), keyword defaults of :func:`run`:
  B = 1024 rays x 192 samples = 196,608 points
  L = 16 levels, K = 2^D = 8 corners, C = 2 channels
  N = B * K = 1,572,864 updates per level
  table: [16, 2^19, 2] f32 = 64 MiB

Run from the repository root (the card is the default device):

    python3 scripts/microbench_encoder_torch.py [--only fwd_take,sort,...]
        [--device cuda|cpu]

Each row prints the median of 20 calls (after 3 warm-up calls) in ms and
in ns per element, timed by ``utils/profiling.py::time_fn`` (CUDA events
around each call on the card), as ``chip_smoke.py`` times its kernels.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from neuralvolumetricreconstructionformedicalimages_torch.ops.scatter_level import (  # noqa: E402
    scatter_level,
)
from neuralvolumetricreconstructionformedicalimages_torch.utils.profiling import (  # noqa: E402
    time_fn,
)

NAMES = ("fwd_take", "fwd_take_bf16", "bwd_take", "bwd_at_add", "sort", "sort3",
         "segsum_sorted", "onehot", "pallas_scatter")
ONEHOT_WIDTH = 512   # one-hot width of the bucket-matmul building block
ONEHOT_M = 2048      # updates per bucket


def report(name: str, secs: float, n_elems: int) -> None:
    print(f"{name:44s} {secs*1e3:9.2f} ms   {secs/n_elems*1e9:8.3f} ns/elem",
          flush=True)


def make_data(gen: torch.Generator, device, B: int, L: int, S: int, C: int, K: int):
    table = torch.randn((L, S, C), generator=gen, device=device) * 1e-2
    idx = torch.randint(0, S, (B, L, K), generator=gen, device=device,
                        dtype=torch.int32)
    w = torch.rand((B, L, K), generator=gen, device=device)
    return table, idx, w


# --- forward: flat gather over [L*S, C] --------------------------------------
def fwd_take(table, idx, w):
    L, S, C = table.shape
    B = idx.shape[0]
    off = torch.arange(L, device=idx.device)[None, :, None] * S
    vals = table.reshape(L * S, C)[idx.long() + off]             # [B, L, K, C]
    return torch.sum(w[..., None] * vals, dim=2).reshape(B, L * C)


# --- backward of the gather (autograd's scatter-add) --------------------------
def bwd_take(table, idx, w, ct):
    t = table.detach().requires_grad_(True)
    return torch.autograd.grad(fwd_take(t, idx, w), t, ct)[0]


# --- direct index_add_ ---------------------------------------------------------
def bwd_at_add(idx, payload, S):
    B, L, K = idx.shape
    C = payload.shape[-1]
    flat = (idx.long() + torch.arange(L, device=idx.device)[None, :, None] * S)
    z = torch.zeros((L * S, C), dtype=torch.float32, device=idx.device)
    return z.index_add_(0, flat.reshape(-1), payload.reshape(-1, C))


# --- per-level sort + payload gathers, as the port's encoder sorts -------------
def sort_kv(keys, val):
    sk, perm = torch.sort(keys, dim=-1, stable=True)
    return sk, torch.gather(val, -1, perm)


def sort3(keys, v1, v2):
    sk, perm = torch.sort(keys, dim=-1, stable=True)
    return sk, torch.gather(v1, -1, perm), torch.gather(v2, -1, perm)


# --- sorted segment sum ----------------------------------------------------------
def bwd_sorted_segsum(keys_sorted, payload_sorted, S):
    """Per level: [L, N] sorted keys, [L, N, C] payload -> [L, S, C]."""
    L = keys_sorted.shape[0]
    C = payload_sorted.shape[-1]
    flat = keys_sorted.long() + torch.arange(L, device=keys_sorted.device)[:, None] * S
    z = torch.zeros((L * S, C), dtype=torch.float32, device=keys_sorted.device)
    return z.index_add_(0, flat.reshape(-1), payload_sorted.reshape(-1, C)).reshape(L, S, C)


# --- one-hot product throughput (the bucket-matmul building block) ------------
def onehot_matmul(local_idx, payload):
    """local_idx [Nb, M], payload [Nb, M, C] -> [Nb, 512, C] f32 (bf16 operands)."""
    width = torch.arange(ONEHOT_WIDTH, device=local_idx.device, dtype=torch.int32)
    oh = (local_idx[..., None] == width).to(torch.bfloat16)
    return torch.einsum("nmk,nmc->nkc", oh, payload.to(torch.bfloat16)).float()


def _first(out) -> torch.Tensor:
    return out[0] if isinstance(out, (tuple, list)) else out


def run(names=None, device="cuda", *, B: int = 196_608, L: int = 16,
        S: int = 1 << 19, C: int = 2, K: int = 8, iters: int = 20) -> dict:
    """Run the benches in ``names`` (all by default) on ``device``.

    Prints one row per bench and returns ``{name: {"label", "ms",
    "ns_per_elem", "n_elems", "min_ms", "checksum"}}``; ``ms`` is the
    median of ``iters`` timed calls, ``min_ms`` the best of them,
    ``checksum`` the f64 sum of the bench's (first) output.
    """
    names = NAMES if names is None else tuple(names)
    unknown = set(names) - set(NAMES)
    if unknown:
        raise ValueError(f"unknown bench names {sorted(unknown)}; known: {NAMES}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    gen = torch.Generator(device=dev).manual_seed(0)
    N = B * K
    table, idx, w = make_data(gen, dev, B, L, S, C, K)
    n_total = B * L * K
    rows = {}

    def bench(name, label, fn, args, n_elems):
        r = time_fn(fn, *args, warmup=3, iters=iters)
        report(label, r["median_s"], n_elems)
        rows[name] = dict(label=label, ms=r["median_s"] * 1e3,
                          ns_per_elem=r["median_s"] / n_elems * 1e9, n_elems=n_elems,
                          min_ms=r["min_s"] * 1e3,
                          checksum=float(_first(fn(*args)).double().sum()))

    def keys_by_level():
        return idx.permute(1, 0, 2).reshape(L, N).contiguous()

    if "fwd_take" in names:
        bench("fwd_take", "fwd take f32 [L*S,C]", fwd_take, (table, idx, w), n_total)
    if "fwd_take_bf16" in names:
        bench("fwd_take_bf16", "fwd take bf16", fwd_take,
              (table.to(torch.bfloat16), idx, w), n_total)
    if "bwd_take" in names:
        ct = torch.ones((B, L * C), device=dev)
        bench("bwd_take", "bwd take-VJP scatter", bwd_take, (table, idx, w, ct),
              n_total)
    if "bwd_at_add" in names:
        payload = torch.randn((B, L, K, C), generator=gen, device=dev)
        bench("bwd_at_add", "bwd index_add_ unsorted", bwd_at_add,
              (idx, payload, S), n_total)
    if "sort" in names:
        val = torch.randn((L, N), generator=gen, device=dev)
        bench("sort", f"sort [{L},{N}] 1 payload", sort_kv, (keys_by_level(), val),
              n_total)
    if "sort3" in names:
        v1 = torch.randn((L, N), generator=gen, device=dev)
        v2 = torch.randn((L, N), generator=gen, device=dev)
        bench("sort3", "sort 2 payloads", sort3, (keys_by_level(), v1, v2), n_total)
    if "segsum_sorted" in names:
        keys_sorted = torch.sort(keys_by_level(), dim=-1).values
        payload = torch.randn((L, N, C), generator=gen, device=dev)
        bench("segsum_sorted", "bwd index_add_ sorted (per level)",
              bwd_sorted_segsum, (keys_sorted, payload, S), n_total)
    if "onehot" in names:
        # N updates in buckets of 2048, one-hot width 512
        nb, m = max(1, N // ONEHOT_M), min(ONEHOT_M, N)
        li = torch.randint(0, ONEHOT_WIDTH, (nb, m), generator=gen, device=dev,
                           dtype=torch.int32)
        pay = torch.randn((nb, m, C), generator=gen, device=dev)
        bench("onehot", "onehot bucket-matmul 1 level equiv", onehot_matmul,
              (li, pay), nb * m)
    if "pallas_scatter" in names:
        idx_l = idx[:, 0, :].reshape(N).contiguous()
        pay_l = torch.randn((N, C), generator=gen, device=dev)
        bench("pallas_scatter", "scatter_level kernel (1 level)", scatter_level,
              (idx_l, pay_l, S), N)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma list of bench names")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    only = [n for n in args.only.split(",") if n] or None
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("microbench_encoder_torch: no CUDA device available",
                  file=sys.stderr)
            return 1
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    else:
        print(f"device: {dev}", flush=True)
    run(only, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
