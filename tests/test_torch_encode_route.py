"""The sorted encoder's kernel sequence on the CPU: the plain versions of
the index kernel, the span gather's point-order mode, the feature unpack,
the gradient transpose and the gradient-permute kernel
(``ops/span_gather.py``) ``torch.equal`` to the PyTorch ops they replace,
and ``sorted_encode``, which runs that sequence on every device, equal to
those ops in features and table gradients.  The XOR path's index math
(``ops/hash_encoding.py``): ``xor_index`` runs its plain version on the
CPU; the route, the kernel's argument checks, and its uint32 arithmetic
(modelled in numpy) against the PyTorch ops.

The kernels themselves are held against these plain versions on the card
in ``test_torch_cuda.py``.  Point sets: ``tests/_encode_points.py``.
"""

import types

import numpy as np
import pytest
import torch

import _encode_points as P
from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
from neuralvolumetricreconstructionformedicalimages_torch.ops import hash_encoding as he
from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
    base_and_frac_t)

GRID = [(s, c) for s in sorted(P.SPECS) for c in P.CASES]
IDS = [f"{s}-{c}" for s, c in GRID]
NEW_COUNTS = ("encode_index", "span_gather_sorted[table,point_order]",
              "unpack_feats_t", "transpose_grad_t", "encode_grad_permute")
# the wrappers ``sorted_encode`` calls with packed positions, in call order
SEQUENCE = ("encode_index", "span_gather_point_order", "unpack_feats_t",
            "transpose_grad_t", "encode_grad_permute")


def _table(spec, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((spec.num_levels, spec.table_size, 2), generator=g)


@pytest.mark.parametrize("spec_name,case", GRID, ids=IDS)
def test_encode_index_plain_equals_pytorch_ops(spec_name, case):
    """base [L, B] and packed positions [L, B]: ``torch.equal`` to
    ``base_and_frac_t`` followed by ``pack_frac_t``; the wrapper runs the
    plain version for CPU tensors and counts no launch."""
    spec = P.SPECS[spec_name]
    x = P.points(case, spec, seed=1)
    base_t, frac_t = base_and_frac_t(spec, x)
    base, pos = sg.encode_index_plain(spec, x)
    assert base.dtype == pos.dtype == torch.int32
    assert torch.equal(base, base_t)
    assert torch.equal(pos, sg.pack_frac_t(frac_t))
    n0 = dict(_build.LAUNCHES)
    w = sg.encode_index(spec, x)
    assert torch.equal(w[0], base) and torch.equal(w[1], pos)
    assert dict(_build.LAUNCHES) == n0


@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("spec_name,case", GRID, ids=IDS)
def test_point_order_gather_plain_equals_pytorch_ops(spec_name, case, table_dtype):
    """spf [L, B] and the point-order bf16 pairs [L, B]: ``torch.equal`` to
    the gather of the positions, the table-mode gather, ``_pack_feats`` and
    ``scatter_``."""
    spec = P.SPECS[spec_name]
    x = P.points(case, spec, seed=2)
    table = _table(spec, 3)
    sk, perm, pos, spf_ref, packed_ref, _ = P.glue_forward(spec, x, table, table_dtype)
    spf, feats = sg.span_gather_point_order_plain(sk, perm, pos, table, spec, table_dtype)
    assert spf.dtype == feats.dtype == torch.int32 and feats.shape == pos.shape
    assert torch.equal(spf, spf_ref)
    assert torch.equal(feats, packed_ref)
    w = sg.span_gather_point_order(sk, perm, pos, table, spec, table_dtype)
    assert torch.equal(w[0], spf) and torch.equal(w[1], feats)


@pytest.mark.parametrize("spec_name,case", GRID, ids=IDS)
def test_unpack_feats_t_plain_equals_pytorch_ops(spec_name, case):
    """The point-order features [B, L*2] from the bf16 pairs [L, B]:
    ``torch.equal`` to ``_unpack_feats`` of the transpose; the wrapper runs
    the plain version for CPU tensors."""
    spec = P.SPECS[spec_name]
    x = P.points(case, spec, seed=3)
    *_, packed, out_ref = P.glue_forward(spec, x, _table(spec, 4), torch.bfloat16)
    out = sg.unpack_feats_t_plain(packed)
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert torch.equal(out, out_ref)
    assert torch.equal(sg.unpack_feats_t(packed), out)


@pytest.mark.parametrize("spec_name,case", GRID, ids=IDS)
def test_transpose_grad_t_plain_equals_a_permuted_view(spec_name, case):
    """The output gradient [B, L*2] -> [L, B, 2], ``torch.equal`` to the
    view ``g.reshape(B, L, 2).transpose(0, 1)``; the wrapper runs the plain
    version for CPU tensors."""
    spec = P.SPECS[spec_name]
    L, B = spec.num_levels, P.points(case, spec).shape[0]
    g = torch.randn((B, L * 2), generator=torch.Generator().manual_seed(5))
    gT = sg.transpose_grad_t_plain(g, L)
    assert gT.shape == (L, B, 2) and gT.is_contiguous()
    assert torch.equal(gT, g.reshape(B, L, 2).transpose(0, 1))
    assert torch.equal(sg.transpose_grad_t(g, L), gT)


@pytest.mark.parametrize("spec_name,case", GRID, ids=IDS)
def test_grad_permute_plain_equals_pytorch_ops(spec_name, case):
    """sg [L, 2, B] and sf [L, 3, B] from the level-major gradient:
    ``torch.equal`` to the gather of the output gradient by the
    permutation and ``unpack_frac_t``."""
    spec = P.SPECS[spec_name]
    x = P.points(case, spec, seed=4)
    L, B = spec.num_levels, x.shape[0]
    _, perm, _, spf, _, _ = P.glue_forward(spec, x, _table(spec, 5), torch.bfloat16)
    g = torch.randn((B, L * 2), generator=torch.Generator().manual_seed(6))
    gt = g.reshape(B, L, 2).permute(1, 2, 0)
    sg_ref = torch.gather(gt, 2, perm[:, None, :].expand(L, 2, B))
    gT = sg.transpose_grad_t_plain(g, L)
    sgr, sf = sg.encode_grad_permute_plain(perm, spf, gT)
    assert sgr.is_contiguous() and sf.is_contiguous()
    assert torch.equal(sgr, sg_ref)
    assert torch.equal(sf, sg.unpack_frac_t(spf))
    w = sg.encode_grad_permute(perm, spf, gT)
    assert torch.equal(w[0], sgr) and torch.equal(w[1], sf)


@pytest.mark.parametrize("spec_name,case", GRID, ids=IDS)
def test_sorted_encode_kernel_route_equals_pytorch_route(monkeypatch, spec_name, case):
    """``sorted_encode`` on the CPU calls the card's sequence of wrappers
    (each runs its plain version and counts no launch) and is
    ``torch.equal``, in features and table gradients, to the PyTorch ops
    that sequence replaces (``_encode_points.glue_forward`` and
    ``glue_backward``), on [rays, samples, 3] points."""
    spec = P.SPECS[spec_name]
    x = P.points(case, spec, seed=7)
    x = x[: x.shape[0] // 4 * 4].reshape(4, -1, 3)
    ct = torch.randn((*x.shape[:-1], spec.output_dim),
                     generator=torch.Generator().manual_seed(8))
    table = _table(spec, 9)
    calls = []
    for name in SEQUENCE:
        monkeypatch.setattr(sg, name, lambda *a, _n=name, _f=getattr(sg, name), **k:
                            calls.append(_n) or _f(*a, **k))
    n0 = {k: _build.LAUNCHES[k] for k in NEW_COUNTS}
    t = table.clone().requires_grad_(True)
    out = sg.sorted_encode(x, t, spec, torch.bfloat16, True)
    (out * ct).sum().backward()
    assert calls == list(SEQUENCE)
    assert {k: _build.LAUNCHES[k] for k in NEW_COUNTS} == n0
    assert out.shape == ct.shape
    sk, perm, _, spf, _, ref = P.glue_forward(spec, x.reshape(-1, 3), table,
                                              torch.bfloat16)
    assert torch.equal(out.detach(), ref.reshape(out.shape))
    ref_grad = P.glue_backward(spec, sk, perm, spf, ct.reshape(-1, spec.output_dim))
    assert torch.equal(t.grad, ref_grad)


# ---- the XOR path's index math (ops/hash_encoding.py::xor_index) ----

XOR_GRID = [(s, c) for s in (*sorted(P.SPECS), "main") for c in P.XOR_CASES]
XOR_IDS = [f"{s}-{c}" for s, c in XOR_GRID]


def _xor_spec(name):
    return P.MAIN_SPEC if name == "main" else P.SPECS[name]


@pytest.mark.parametrize("spec_name,case", XOR_GRID, ids=XOR_IDS)
def test_xor_indices_on_the_cpu_are_the_plain_version(spec_name, case):
    """On the CPU ``_indices_weights_frac`` and ``xor_index`` return the
    plain version's idx, w and frac (``torch.equal``) and count no launch."""
    spec = _xor_spec(spec_name)
    x = P.points(case, spec, seed=10)
    n0 = _build.LAUNCHES["xor_index"]
    ref = he._indices_weights_frac_plain(spec, x)
    assert [t.dtype for t in ref] == [torch.int32, torch.float32, torch.float32]
    for got in (he._indices_weights_frac(spec, x), he.xor_index(spec, x)):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert _build.LAUNCHES["xor_index"] == n0


def _xor_index_numpy(spec, x):
    """The arithmetic of ``xor_index_kernel`` in numpy: pos in two f32
    roundings, rows in uint32 with wraparound masked to S - 1, weights
    grouped (t0 * t2) * t1 in f32."""
    x = x.numpy().astype(np.float32)
    pos = (x[:, None, :] * spec.scales[None, :, None]).astype(np.float32)
    pos = (pos + np.float32(0.5)).astype(np.float32)
    f = (pos - np.floor(pos)).astype(np.float32)                  # [B, L, 3]
    o = (np.float32(1) - f).astype(np.float32)
    g = np.floor(pos).astype(np.int64).astype(np.uint32)
    bits = (np.arange(8)[:, None] >> np.arange(3)) & 1            # [8, 3]
    c = g[:, :, None, :] + bits.astype(np.uint32)                 # [B, L, 8, 3]
    res_p1 = (spec.resolutions + 1).astype(np.uint64)
    strides = (np.stack([res_p1 ** d for d in range(3)], -1) & 0xFFFFFFFF).astype(np.uint32)
    dense = (c * strides[None, :, None, :]).sum(-1, dtype=np.uint32)
    primes = np.array([1, 19349663, 83492791], np.uint32)
    hashed = (c[..., 0] * primes[0]) ^ (c[..., 1] * primes[1]) ^ (c[..., 2] * primes[2])
    rows = np.where(spec.dense_levels[None, :, None], dense, hashed)
    rows = (rows & np.uint32(spec.table_size - 1)).astype(np.int32)
    t = np.where(bits[None, None] > 0, f[:, :, None, :], o[:, :, None, :])
    w = ((t[..., 0] * t[..., 2]).astype(np.float32) * t[..., 1]).astype(np.float32)
    return rows, w, f


@pytest.mark.parametrize("spec_name,case", XOR_GRID, ids=XOR_IDS)
def test_xor_kernel_arithmetic_matches_the_pytorch_ops(spec_name, case):
    """The kernel's uint32 rows and its f32 positions ``equal`` the int64
    PyTorch ops' (the low 32 bits agree and 2^S divides 2^32); its weights
    (another grouping of the product than the CPU's) agree within two
    ulps."""
    spec = _xor_spec(spec_name)
    x = P.points(case, spec, seed=11)
    idx, w, frac = he._indices_weights_frac_plain(spec, x)
    rows, wn, fn = _xor_index_numpy(spec, x)
    np.testing.assert_array_equal(idx.numpy(), rows)
    np.testing.assert_array_equal(frac.numpy(), fn)
    np.testing.assert_allclose(w.numpy(), wn, rtol=2.5e-7, atol=0)


def _on_card(requires_grad=False):
    """A stand-in for a CUDA tensor (no card here)."""
    return types.SimpleNamespace(is_cuda=True, requires_grad=requires_grad)


@pytest.mark.parametrize("spec,x,grad,expect", [
    (P.MAIN_SPEC, _on_card(), True, True),
    (P.MAIN_SPEC, torch.zeros((4, 3)), True, True),
    (he.HashGridSpec(input_dim=2), _on_card(), True, False),
    (he.HashGridSpec(num_levels=33), _on_card(), True, False),
    (P.MAIN_SPEC, _on_card(True), True, False),
    (P.MAIN_SPEC, _on_card(True), False, True),
], ids=["card", "cpu", "input_dim_2", "33_levels", "grad_asked",
        "grad_asked_no_grad_mode"])
def test_xor_kernel_route(spec, x, grad, expect):
    """``xor_index`` takes D = 3, at most 32 levels, and no gradient asked
    of the points (under grad mode), on either device (it runs its plain
    version for CPU tensors); anything else takes the PyTorch ops."""
    with torch.set_grad_enabled(grad):
        assert he._xor_kernel_route(spec, x) is expect


def test_xor_indices_of_two_dimensional_points_are_the_plain_version():
    """input_dim 2 takes the PyTorch ops, which the kernel does not cover."""
    spec = he.HashGridSpec(input_dim=2, num_levels=4, base_resolution=4,
                           log2_hashmap_size=10)
    x = torch.rand((500, 2), generator=torch.Generator().manual_seed(12))
    n0 = _build.LAUNCHES["xor_index"]
    got = he._indices_weights_frac(spec, x)
    ref = he._indices_weights_frac_plain(spec, x)
    assert got[0].shape == (500, 4, 4) and got[2].shape == (500, 4, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert _build.LAUNCHES["xor_index"] == n0


@pytest.mark.parametrize("spec,shape,match", [
    (P.MAIN_SPEC, (5, 2), r"\[B, 3\] points"),
    (P.MAIN_SPEC, (5, 3, 1), r"\[B, 3\] points"),
    (P.MAIN_SPEC, (3,), r"\[B, 3\] points"),
    (he.HashGridSpec(input_dim=2), (5, 3), "input_dim 2"),
    (he.HashGridSpec(num_levels=33), (5, 3), "at most 32 levels"),
], ids=["B2", "B31", "flat", "input_dim_2", "33_levels"])
def test_xor_index_refuses_what_the_kernel_does_not_take(spec, shape, match):
    """The wrapper's checks, called without a card: a clear ValueError."""
    with pytest.raises(ValueError, match=match):
        he._check_xor_index(spec, torch.zeros(shape))
    he._check_xor_index(P.MAIN_SPEC, torch.zeros((5, 3)))
