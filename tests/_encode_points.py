"""Point sets for the sorted encoder's index, point-order gather and
gradient-permute kernels (``ops/span_gather.py``) and their plain
versions, shared by the CPU tests and the card tests: uniform points,
points at and next to cell edges (where a fused multiply-add would move
``floor(x * scale + 0.5)``), the cube's corners and faces (x = 0 and x =
1), 700 identical points, and a count that is not a multiple of the
kernels' 256-thread block; for the XOR path's index kernel also the cube's
corners and faces approached from inside.  Also the PyTorch ops that
those kernels replace (:func:`glue_forward`, :func:`glue_backward`), the
reference ``sorted_encode`` is held to on both devices, and the XOR
backward's corner streams (:func:`corner_stream`) for its corner sort
(``ops/hash_encoding.py::sorted_corner_stream``).  Imports no JAX."""

import numpy as np
import torch

from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
from neuralvolumetricreconstructionformedicalimages_torch.ops.bucket_matmul import (
    bucket_grad_matmul)
from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
    base_and_frac_t)
from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (
    HashGridSpec)
from neuralvolumetricreconstructionformedicalimages_torch.ops.roll_kernels import (
    _PAD, unroll_reduce_fm)

CASES = ("uniform", "cell_edges", "ends", "identical_700", "ragged")
# the XOR path's index kernel takes these and the cube's corners and faces
# approached from inside (x = nextafter(0, 1) and nextafter(1, 0))
XOR_CASES = CASES + ("near_ends",)
# every level dense ((res+1)^3 <= 2^19) / every level hashed
SPECS = {"dense": HashGridSpec(num_levels=3, base_resolution=4, log2_hashmap_size=19),
         "hashed": HashGridSpec(num_levels=3, base_resolution=16, log2_hashmap_size=12)}


# the main path's spec and its points a level at 1,024 rays: chest_50
# (192 samples a ray) and abdomen_50 (576)
MAIN_SPEC = HashGridSpec(num_levels=16, base_resolution=16, log2_hashmap_size=19)
MAIN_B = {"chest": 196_608, "abdomen": 589_824}
# the verify drive's grid (scripts/verify_drive_torch.py) and its points a
# level (512 rays x 192 samples)
VERIFY_SPEC = HashGridSpec(num_levels=8, base_resolution=16, log2_hashmap_size=15)
VERIFY_B = 98_304


def points(case: str, spec: HashGridSpec, seed: int = 0, n: int = 2048) -> torch.Tensor:
    """[B, 3] f32 points in [0, 1] on the CPU (``n`` of them, uniform)."""
    rng = np.random.default_rng(seed)
    if case == "uniform":
        x = rng.uniform(0, 1, (n, 3))
    elif case == "ragged":
        x = rng.uniform(0, 1, (1027, 3))
    elif case == "identical_700":
        x = np.tile(rng.uniform(0, 1, (1, 3)), (700, 1))
    elif case == "ends":
        corners = (np.arange(8)[:, None] >> np.arange(3)) & 1
        faces = rng.uniform(0, 1, (504, 3))
        faces[np.arange(504), np.arange(504) % 3] = np.arange(504) % 2
        x = np.concatenate([corners, faces])
    elif case == "near_ends":
        v = np.array([0.0, np.nextafter(np.float32(0), np.float32(1)),
                      np.nextafter(np.float32(1), np.float32(0)), 1.0], np.float32)
        grid = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
        x = np.concatenate([grid, rng.uniform(0, 1, (448, 3))])
    elif case == "cell_edges":
        # (k - 0.5) / scale of each level and its f32 neighbours: some round
        # x * scale to exactly k - 0.5, putting pos on the edge k
        cols = []
        for s in spec.scales.astype(np.float64):
            k = rng.integers(1, int(s) + 1, 2048 // (3 * len(spec.scales)) + 1)
            e = ((k - 0.5) / s).astype(np.float32)
            cols.append(np.concatenate([np.nextafter(e, np.float32(0)), e,
                                        np.nextafter(e, np.float32(1))]))
        v = np.concatenate(cols)
        x = np.stack([v, rng.permutation(v), rng.permutation(v)], axis=1)
    else:
        raise ValueError(case)
    return torch.as_tensor(np.clip(x, 0, 1), dtype=torch.float32)


def glue_forward(spec: HashGridSpec, x: torch.Tensor, table: torch.Tensor, table_dtype):
    """The sorted encoder's forward in PyTorch ops around the span gather's
    table mode: index math, packing, the sort, the positions gathered to
    sorted order, the gather, the bf16 pack, the scatter back to point
    order and the unpack.  Returns (sorted keys, perm, pos, sorted pos, the
    point-order bf16 pairs, the features [B, L*2])."""
    base_t, frac_t = base_and_frac_t(spec, x)
    pos = sg.pack_frac_t(frac_t)
    sk, perm = torch.sort(base_t, dim=-1, stable=True)
    spf = torch.gather(pos, 1, perm)
    fs = sg.span_gather_sorted_table(sk, spf[:, None, :], table, spec, table_dtype)
    packed_sorted = sg._pack_feats(fs)
    packed = torch.empty_like(packed_sorted).scatter_(1, perm, packed_sorted)
    out = sg._unpack_feats(packed.t())
    return sk, perm, pos, spf, packed, out.reshape(x.shape[0], -1)


def glue_backward(spec: HashGridSpec, sk: torch.Tensor, perm: torch.Tensor,
                  spf: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The table gradient [L, S, 2] of :func:`glue_forward` for the output
    gradient ``g`` [B, L*2]: ``g`` gathered to sorted order by ``perm``,
    the packed positions unpacked (the quantised positions the forward
    interpolated with), the bucket and the unroll."""
    L, B = sk.shape
    sf = sg.unpack_frac_t(spf)
    gt = g.reshape(B, L, 2).permute(1, 2, 0).to(torch.float32)   # [L, 2, B]
    sgr = torch.gather(gt, 2, perm[:, None, :].expand(L, 2, B))
    grad_rolled = bucket_grad_matmul(sk, sf, sgr, table_size=spec.table_size,
                                     input_dim=spec.input_dim, extend_cols=_PAD)
    return unroll_reduce_fm(grad_rolled, spec, 2)


# The XOR backward's corner streams (idx, w, g) of the corner sort: uniform
# points; few distinct points repeated; every entry of level 5 in one row;
# a grid whose levels are all dense (the coarsest with 5^3 rows, long
# runs); rows 0 and S - 1 alone; and 1,027 points (N = 8,216 entries a
# level, not a multiple of the kernels' 256-thread block).
CORNER_CASES = ("uniform", "duplicate_heavy", "one_row", "dense_coarse", "row_edges",
                "ragged")


def corner_stream(case: str, seed: int = 0, n: int = 512):
    """(spec, idx [B, L, 8] int32, w [B, L, 8] f32, g [B, L, 2] f32) on the
    CPU for one of ``CORNER_CASES``; g is a strided view of a [2, L, B]
    array, as the smoke script and the bucket script pass it."""
    from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (
        _indices_weights_frac_plain)

    rng = np.random.default_rng(seed)
    spec = SPECS["dense"] if case == "dense_coarse" else MAIN_SPEC
    if case == "duplicate_heavy":
        x = rng.uniform(0, 1, (5, 3))[rng.integers(0, 5, n)]
    else:
        x = rng.uniform(0, 1, (1027 if case == "ragged" else n, 3))
    idx, w, _ = _indices_weights_frac_plain(spec, torch.as_tensor(x, dtype=torch.float32))
    if case == "one_row":
        idx[:, 5, :] = 12345
    elif case == "row_edges":
        edges = np.array([0, spec.table_size - 1], np.int32)
        idx = torch.as_tensor(edges[rng.integers(0, 2, tuple(idx.shape))])
    g = torch.as_tensor(rng.standard_normal((2, spec.num_levels, idx.shape[0])),
                        dtype=torch.float32).permute(2, 1, 0)
    return spec, idx, w, g
