"""The XOR backward's corner sort (``ops/hash_encoding.py::
sorted_corner_stream``) on the CPU: the wrapper returns its plain version
for CPU tensors; a numpy model of the card's algorithm (composite keys of
ceil(log2 L) level bits above log2 S row bits, stable LSD passes of 8
bits, the level bits stripped, the payload formed from the sorted stream
positions) is ``torch.equal`` to that plain version; the argument checks
refuse what the kernels do not take.  The kernels themselves are held
against the plain version on the card in ``test_torch_cuda.py``.  Streams:
``tests/_encode_points.py::corner_stream``.  Imports no JAX."""

import numpy as np
import pytest
import torch

import _encode_points as P
from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
from neuralvolumetricreconstructionformedicalimages_torch.ops import hash_encoding as he


def _pass_widths(L: int, table_size: int):
    """The LSD passes of the card's sort: 8 bits each, the last the rest."""
    bits = (L - 1).bit_length() + table_size.bit_length() - 1
    return [min(8, bits - lo) for lo in range(0, bits, 8)]


def corner_sort_numpy(idx, w, g, table_size):
    """The card's algorithm in numpy: slot l*N + n (n = b*8 + k) holds the
    key (l << log2 S) | idx[b, l, k] and the value n; stable passes over
    8-bit digits from the lowest; then sk = key & (S - 1) and sg[l, c, j] =
    w[b, l, k] * g[b, l, c] in f32 for the value n = b*8 + k at slot j."""
    idx, w, g = idx.numpy(), w.numpy(), g.numpy()
    B, L, K = idx.shape
    N, sbits = B * K, table_size.bit_length() - 1
    keys = ((np.arange(L, dtype=np.uint32)[:, None] << np.uint32(sbits))
            | idx.transpose(1, 0, 2).reshape(L, N).astype(np.uint32)).reshape(-1)
    vals = np.tile(np.arange(N, dtype=np.int32), L)
    lo = 0
    for width in _pass_widths(L, table_size):
        digit = (keys >> np.uint32(lo)) & np.uint32((1 << width) - 1)
        order = np.argsort(digit, kind="stable")     # a stable counting pass
        keys, vals = keys[order], vals[order]
        lo += width
    keys, vals = keys.reshape(L, N), vals.reshape(L, N)
    assert (keys >> np.uint32(sbits) == np.arange(L)[:, None]).all()   # level runs
    sk = (keys & np.uint32(table_size - 1)).astype(np.int32)
    b, k = vals // K, vals % K
    lv = np.arange(L)[:, None]
    sg = (w[b, lv, k][:, None, :] * np.moveaxis(g[b, lv, :], -1, 1)).astype(np.float32)
    return torch.as_tensor(sk), torch.as_tensor(sg)


def test_pass_widths_of_the_cell():
    """NAF's grid (16 levels x 2^19) sorts 23-bit keys in passes of 8, 8, 7."""
    assert _pass_widths(16, 1 << 19) == [8, 8, 7]
    assert _pass_widths(3, 1 << 19) == [8, 8, 5]


@pytest.mark.parametrize("case", P.CORNER_CASES)
def test_card_algorithm_equals_the_plain_version(case):
    """The numpy model of the card's sort and payload ``torch.equal`` to
    ``sorted_corner_stream_plain`` in sk and sg."""
    spec, idx, w, g = P.corner_stream(case, seed=70)
    sk, sg = he.sorted_corner_stream_plain(idx, w, g)
    msk, msg = corner_sort_numpy(idx, w, g, spec.table_size)
    L, N = spec.num_levels, idx.shape[0] * 8
    assert sk.shape == (L, N) and sg.shape == (L, 2, N)
    assert sk.is_contiguous() and sg.is_contiguous()
    assert torch.equal(sk, msk) and torch.equal(sg, msg)


@pytest.mark.parametrize("case", P.CORNER_CASES)
def test_corner_sort_on_the_cpu_is_the_plain_version(case):
    """On CPU tensors the wrapper returns the plain version's tensors, with
    or without a table size, and counts no launch."""
    spec, idx, w, g = P.corner_stream(case, seed=71)
    n0 = _build.LAUNCHES["xor_corner_sort"]
    ref = he.sorted_corner_stream_plain(idx, w, g)
    for got in (he.sorted_corner_stream(idx, w, g),
                he.sorted_corner_stream(idx, w, g, spec.table_size)):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert _build.LAUNCHES["xor_corner_sort"] == n0


def _args(B=4, L=16, K=8, C=2, S=1 << 19, idx_dtype=torch.int32,
          w_dtype=torch.float32, g_dtype=torch.float32):
    """Stand-ins for the wrapper's arguments (expanded zeros: no storage)."""
    z = torch.zeros(1)
    return (z.to(idx_dtype).expand(B, L, K), z.to(w_dtype).expand(B, L, K),
            z.to(g_dtype).expand(B, L, C), S)


@pytest.mark.parametrize("kw,match", [
    (dict(K=4), r"idx \[B, L, 8\]"),
    (dict(idx_dtype=torch.int64), "int32 idx"),
    (dict(w_dtype=torch.float64), "f32 w and g"),
    (dict(w_dtype=torch.bfloat16), "f32 w and g"),
    (dict(g_dtype=torch.float16), "f32 w and g"),
    (dict(S=None), "power-of-two table_size"),
    (dict(S=3 << 17), "power-of-two table_size"),
    (dict(L=17, S=1 << 27), "<= 31 bits"),
    (dict(L=33, S=1 << 10), "at most 32 levels"),
    (dict(L=2, S=1 << 31), "<= 31 bits"),
    (dict(B=1 << 24), "fewer than 2\\^31 entries"),
    (dict(C=4), r"g \[B, L, 2\]"),
    (dict(C=1), r"g \[B, L, 2\]"),
], ids=["K4", "idx_int64", "w_f64", "w_bf16", "g_f16", "no_table_size",
        "table_size_not_pow2", "32_bit_keys_L17", "33_levels", "32_bit_keys_S31", "2_31_entries",
        "C4", "C1"])
def test_corner_sort_refuses_what_the_kernels_do_not_take(kw, match):
    """The wrapper's checks, called without a card: a clear ValueError."""
    with pytest.raises(ValueError, match=match):
        he._check_corner_sort(*_args(**kw))


def test_corner_sort_checks_take_the_cell_and_strided_g():
    """The cell's shape (16 levels x 2^19, 23-bit keys), 31-bit keys, and a
    strided g, as the smoke script passes it, pass the checks."""
    he._check_corner_sort(*_args(B=196_608))
    he._check_corner_sort(*_args(L=16, S=1 << 27))
    idx, w, _, S = _args()
    he._check_corner_sort(idx, w, torch.zeros((2, 16, 4)).permute(2, 1, 0), S)
    with pytest.raises(ValueError, match=r"w \[B, L, 8\] and g \[B, L, 2\]"):
        he._check_corner_sort(idx, w, torch.zeros((4, 15, 2)), S)
