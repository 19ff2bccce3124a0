"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a card (the
decision is taken inside the fixture, so every worker collects the same
tests).  This file imports neither JAX nor the JAX package, so it runs on
a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: rolls are copies (bit-equal); the span gather and the unroll
reduce (f32 or bf16 input) take the same f32 operations in the same order
as the plain versions, up to the plain versions' own kernels (atol 1e-5);
the span gather's table mode reads the values of the rolled mode through
the same arithmetic (bit-equal to it and to its plain version);
the bucket sum is bitwise reproducible run to run, and equals the plain
version bit for bit (both sum every run in stream order from the same f32
products); the scatter's atomics add in no fixed order (rtol/atol 1e-5 on
normal payloads, bit-equal on integer-valued ones, which sum exactly).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
from neuralvolumetricreconstructionformedicalimages_torch.ops import bucket_matmul as bm
from neuralvolumetricreconstructionformedicalimages_torch.ops import coherent_hash as ch
from neuralvolumetricreconstructionformedicalimages_torch.ops import roll_kernels as rk
from neuralvolumetricreconstructionformedicalimages_torch.ops import scatter_level as sl
from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as sg
from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
    base_and_frac_t,
    coherent_encode,
    corner_offsets,
    coherent_encode_takevjp,
)
from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (
    HashGridSpec,
    hash_encode_fast,
)

pytestmark = pytest.mark.cuda

SPEC = HashGridSpec(num_levels=5, base_resolution=4, log2_hashmap_size=14)
L, S, C = 5, 1 << 14, 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _stream(dev, B, seed, dup=False):
    g = _gen(dev, seed)
    keys = torch.randint(0, S, (L, B), generator=g, device=dev, dtype=torch.int32)
    if dup:
        keys[:, : B // 2] = 77
    keys, _ = torch.sort(keys, dim=1)
    frac = torch.rand((L, 3, B), generator=g, device=dev)
    grads = torch.randn((L, C, B), generator=g, device=dev)
    return keys, frac, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roll_broadcast_kernel(dev, dtype):
    table = torch.randn((L, S, C), generator=_gen(dev, 0), device=dev)
    n0 = _build.LAUNCHES["roll_broadcast_fm"]
    out = rk.roll_broadcast_fm(table, SPEC, dtype)
    assert _build.LAUNCHES["roll_broadcast_fm"] == n0 + 1
    assert torch.equal(out, rk.roll_broadcast_fm_plain(table, SPEC, dtype))
    assert torch.equal(out.cpu(), rk.roll_broadcast_fm(table.cpu(), SPEC, dtype))


@dataclasses.dataclass(frozen=True)
class _SizedSpec(HashGridSpec):
    """A spec whose table length need not be a power of two (the roll
    kernels take any S; offsets are masked with S - 1, so they stay < S)."""

    size: int = 3000

    @property
    def table_size(self) -> int:
        return self.size


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [1, 2, 4, 6, 3000, 3001, 2050, 1 << 14])
def test_roll_broadcast_kernel_any_size(dev, dtype, size):
    """Table lengths that are not a multiple of a thread's 8 columns or a
    block's 2048, odd lengths (the scalar kernel), and odd offsets, whose
    column pair crosses the wrap (the pair kernel's per-element case)."""
    spec = _SizedSpec(num_levels=3, base_resolution=4, size=size)
    if size >= 2050 and size % 2 == 0:
        offs = corner_offsets(spec)
        assert (offs % 2 == 1).any() and (offs % 2 == 0).any()
    table = torch.randn((3, size, C), generator=_gen(dev, 17), device=dev)
    n0 = _build.LAUNCHES["roll_broadcast_fm"]
    out = rk.roll_broadcast_fm(table, spec, dtype)
    again = rk.roll_broadcast_fm(table, spec, dtype)
    assert _build.LAUNCHES["roll_broadcast_fm"] == n0 + 2
    assert torch.equal(out, again)
    assert torch.equal(out, rk.roll_broadcast_fm_plain(table, spec, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_", [1, 2, 4])
def test_roll_broadcast_kernel_channels_and_alignment(dev, dtype, C_):
    """Other channel counts (scalar kernel), and a table that starts 8 bytes
    past a 16-byte boundary (the pair kernel's float4 reads do not apply)."""
    spec = HashGridSpec(num_levels=L, base_resolution=4, level_dim=C_,
                        log2_hashmap_size=14)
    n = L * S * C_
    buf = torch.randn(n + 2, generator=_gen(dev, 18), device=dev)
    for table in (buf[:n].view(L, S, C_), buf[2:].view(L, S, C_)):
        out = rk.roll_broadcast_fm(table, spec, dtype)
        assert torch.equal(out, rk.roll_broadcast_fm_plain(table, spec, dtype))


def test_unroll_reduce_kernel(dev):
    g = torch.randn((L, 8 * C, S), generator=_gen(dev, 1), device=dev)
    ext = rk.wrap_extend(g, rk._PAD)
    out = rk.unroll_reduce_fm(ext, SPEC, C)
    torch.testing.assert_close(out, rk.unroll_reduce_fm_plain(ext, SPEC, C),
                               atol=1e-5, rtol=0)


def test_unroll_reduce_kernel_bf16_input(dev):
    """The rolled backward hands the unroll a bf16 gradient."""
    g = torch.randn((L, 8 * C, S), generator=_gen(dev, 11), device=dev)
    ext = rk.wrap_extend(g.to(torch.bfloat16), rk._PAD)
    n0 = _build.LAUNCHES["unroll_reduce_fm"]
    out = rk.unroll_reduce_fm(ext, SPEC, C)
    assert _build.LAUNCHES["unroll_reduce_fm"] == n0 + 1
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, rk.unroll_reduce_fm_plain(ext, SPEC, C),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("C_", [1, 2, 4])
@pytest.mark.parametrize("payload", ["normal", "integer"])
def test_scatter_level_kernel(dev, payload, C_):
    g = _gen(dev, 12)
    N, S_ = 1 << 16, 1 << 12
    idx = torch.randint(0, S_, (N,), generator=g, device=dev, dtype=torch.int32)
    if payload == "normal":
        pay = torch.randn((N, C_), generator=g, device=dev)
    else:
        pay = torch.randint(-50, 50, (N, C_), generator=g, device=dev).float()
    n0 = _build.LAUNCHES["scatter_level"]
    out = sl.scatter_level(idx, pay, S_)
    assert _build.LAUNCHES["scatter_level"] == n0 + 1
    ref = sl.scatter_level_plain(idx, pay, S_)
    if payload == "normal":
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(out, ref)
        assert torch.equal(out.cpu(), sl.scatter_level(idx.cpu(), pay.cpu(), S_))


def test_scatter_level_kernel_long_integer_column(dev):
    """700 integer-valued updates into one row sum exactly in any order."""
    g = _gen(dev, 13)
    idx = torch.randint(0, 4096, (5000,), generator=g, device=dev, dtype=torch.int32)
    idx[:700] = 77
    pay = torch.randint(-9, 9, (5000, 2), generator=g, device=dev).float()
    assert torch.equal(sl.scatter_level(idx, pay, 4096),
                       sl.scatter_level_plain(idx, pay, 4096))


@pytest.mark.parametrize("path", ["coherent", "xor", "take"])
def test_encode_paths_on_card_match_cpu(dev, path):
    """The rolled, XOR and take encoders on the card vs on the CPU
    (positions and table gradients)."""
    fn = {"coherent": lambda x, t: coherent_encode(x, t, SPEC, torch.bfloat16),
          "xor": lambda x, t: hash_encode_fast(x, t, SPEC),
          "take": lambda x, t: coherent_encode_takevjp(x, t, SPEC)}[path]
    x = torch.rand((1500, 3), generator=_gen(dev, 14), device=dev)
    table = torch.randn((L, S, C), generator=_gen(dev, 15), device=dev)
    ct = torch.randn((1500, SPEC.output_dim), generator=_gen(dev, 16), device=dev)
    res = []
    for d in (dev, torch.device("cpu")):
        xx = x.to(d).clone().requires_grad_(True)
        t = table.to(d).clone().requires_grad_(True)
        o = fn(xx, t)
        (o * ct.to(d)).sum().backward()
        res.append((o.detach().cpu(), xx.grad.cpu(), t.grad.cpu()))
    (o0, gx0, gt0), (o1, gx1, gt1) = res
    torch.testing.assert_close(o0, o1, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gt0, gt1, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(gx0, gx1, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dup", [False, True], ids=["random", "duplicate_heavy"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_bucket_kernel(dev, dup, out_dtype):
    keys, frac, grads = _stream(dev, 3000, 2, dup)
    kw = dict(table_size=S, input_dim=3, out_dtype=out_dtype, extend_cols=rk._PAD)
    a = bm.bucket_grad_matmul(keys, frac, grads, **kw)
    b = bm.bucket_grad_matmul(keys, frac, grads, **kw)
    assert torch.equal(a, b)  # deterministic: no atomics
    assert torch.equal(a, bm.bucket_grad_matmul_plain(keys, frac, grads, **kw))


def test_bucket_kernel_no_fracs(dev):
    keys, _, grads = _stream(dev, 2048, 3)
    frac0 = torch.zeros((L, 0, 2048), device=dev)
    a = bm.bucket_grad_matmul(keys, frac0, grads, table_size=S, input_dim=0)
    ref = bm.bucket_grad_matmul_plain(keys, frac0, grads, table_size=S, input_dim=0)
    assert torch.equal(a, ref)


def test_bucket_identical_points(dev):
    """700 identical points: one column owns the whole stream."""
    keys = torch.full((L, 700), 4321, dtype=torch.int32, device=dev)
    frac = torch.full((L, 3, 700), 0.25, device=dev)  # weights exact in f32
    grads = torch.randn((L, C, 700), generator=_gen(dev, 4), device=dev)
    a = bm.bucket_grad_matmul(keys, frac, grads, table_size=S, input_dim=3).cpu()
    w = torch.tensor([np.prod([0.25 if (k >> d) & 1 else 0.75 for d in range(3)])
                      for k in range(8)], dtype=torch.float64)
    exact = (w[None, :, None] * grads.cpu().double().sum(-1)[:, None, :])
    torch.testing.assert_close(a[:, :, 4321].double(), exact.reshape(L, 8 * C),
                               atol=1e-5, rtol=1e-5)  # f32 sum of 700 terms
    a[:, :, 4321] = 0
    assert not a.any()


def _bucket_equal(keys, D, seed, S_, E, out_dtype=torch.float32):
    """Sort ``keys`` per level, draw fracs and grads, and assert that the
    kernel is bit-identical across two runs and bit-equal to the plain
    version.  Returns the kernel's output."""
    dev = keys.device
    keys = torch.sort(keys.to(torch.int32), dim=1).values.contiguous()
    L_, B = keys.shape
    g = _gen(dev, seed)
    frac = torch.rand((L_, D, B), generator=g, device=dev)
    grads = torch.randn((L_, C, B), generator=g, device=dev)
    kw = dict(table_size=S_, input_dim=D, out_dtype=out_dtype, extend_cols=E)
    n0 = _build.LAUNCHES["bucket_grad_matmul"]
    a = bm.bucket_grad_matmul(keys, frac, grads, **kw)
    b = bm.bucket_grad_matmul(keys, frac, grads, **kw)
    assert _build.LAUNCHES["bucket_grad_matmul"] == n0 + 2
    assert a.shape == (L_, (1 << D) * C, S_ + E)
    assert torch.equal(a, b)
    assert torch.equal(a, bm.bucket_grad_matmul_plain(keys, frac, grads, **kw))
    return a


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_bucket_runs_straddle_tile_edges(dev, out_dtype):
    """Runs on both sides of every 256-, 512- and 1024-column boundary
    (the kernel's tiles are 1024 columns), a few updates each."""
    edges = torch.tensor([256, 512, 1024, 2048, 3072, 8192], device=dev)
    cols = torch.stack([edges - 1, edges]).reshape(-1)
    g = _gen(dev, 20)
    pick = torch.randint(0, cols.numel(), (L, 600), generator=g, device=dev)
    spread = torch.randint(0, S, (L, 400), generator=g, device=dev)
    keys = torch.cat([cols[pick], spread], dim=1)
    _bucket_equal(keys, 3, 21, S, rk._PAD, out_dtype)


@pytest.mark.parametrize("D", [0, 3])
def test_bucket_long_segments(dev, D):
    """One column with 5,000 updates, and a tile with 20,000 spread over its
    1024 columns: segments far longer than one sweep of the block."""
    g = _gen(dev, 22)
    keys = torch.cat([
        torch.full((L, 5000), 1500, device=dev, dtype=torch.long),
        torch.randint(4096, 5120, (L, 20000), generator=g, device=dev),
        torch.randint(0, S, (L, 3000), generator=g, device=dev)], dim=1)
    out = _bucket_equal(keys, D, 23, S, rk._PAD)
    assert out[:, :, 1500].abs().sum() > 0


@pytest.mark.parametrize("D", [0, 3])
def test_bucket_long_runs_at_sample_and_slice_edges(dev, D):
    """Runs of 2,047, 2,048 and 2,049 updates (on both sides of the length
    at which a run goes to a slice block), eight 2,048-runs in a row (a
    slice block's most), runs starting on and beside the 1,024-element
    samples and crossing the 16,384-element slices, shifted per level."""
    rng = np.random.default_rng(28)
    lengths = [1, 2048, 2048, 2048, 2048, 2048, 2048, 2048, 2048, 2047, 2049,
               1024, 1025, 16390, 5, 3 * 2048 + 1, 700, 4096]
    B = 60000
    rows = []
    for lv in range(L):
        lens = [lv * 37 + 1] + lengths[1:]
        cols = 100 + 3 * np.arange(len(lens))
        head = np.repeat(cols, lens)
        tail = np.sort(rng.integers(cols[-1] + 1, S, B - head.size))
        rows.append(np.concatenate([head, tail]))
    keys = torch.as_tensor(np.stack(rows), device=dev)
    out = _bucket_equal(keys, D, 29, S, rk._PAD)
    assert out[:, :, 100:100 + 3 * len(lengths):3].abs().sum(1).gt(0).all()


@pytest.mark.parametrize("C_", [1, 4, 8])
@pytest.mark.parametrize("D", [0, 2, 3])
def test_bucket_channel_counts(dev, D, C_):
    """Every (D, C) the kernel takes: each sets how lanes share a long run's
    K*C sums.  Runs of 1-32 (one thread), 33-2047 (a warp in the tile's
    block) and 2048 or more (a slice block)."""
    g = _gen(dev, 30)
    keys = torch.cat([
        torch.full((L, 3000), 700, device=dev, dtype=torch.long),
        torch.randint(5000, 5040, (L, 4000), generator=g, device=dev),
        torch.randint(0, S, (L, 3000), generator=g, device=dev)], dim=1)
    keys, _ = torch.sort(keys.to(torch.int32), dim=1)
    B = keys.shape[1]
    frac = torch.rand((L, D, B), generator=g, device=dev)
    grads = torch.randn((L, C_, B), generator=g, device=dev)
    kw = dict(table_size=S, input_dim=D, extend_cols=rk._PAD)
    a = bm.bucket_grad_matmul(keys, frac, grads, **kw)
    assert torch.equal(a, bm.bucket_grad_matmul(keys, frac, grads, **kw))
    assert torch.equal(a, bm.bucket_grad_matmul_plain(keys, frac, grads, **kw))


@pytest.mark.parametrize("case", ["empty_stream", "one_tile", "last_column"])
def test_bucket_empty_tiles(dev, case):
    """An empty stream (every tile empty), keys confined to one tile (every
    other tile empty), and every key in the table's last column."""
    g = _gen(dev, 24)
    keys = {"empty_stream": torch.zeros((L, 0), dtype=torch.long, device=dev),
            "one_tile": torch.randint(0, 100, (L, 2000), generator=g, device=dev),
            "last_column": torch.full((L, 300), S - 1, device=dev)}[case]
    out = _bucket_equal(keys, 3, 25, S, rk._PAD)
    if case == "empty_stream":
        assert not out.any()
    else:
        assert not out[:, :, 100:S - 1].any()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [0, 2, 3])
def test_bucket_ragged_table(dev, D, out_dtype):
    """S = 3000, not a multiple of the 1024-column tile, with a 4224-column
    extension: longer than a tile and than S, so the wrapped copies cross
    tile edges and wrap twice."""
    keys = torch.randint(0, 3000, (L, 5000), generator=_gen(dev, 26), device=dev)
    out = _bucket_equal(keys, D, 27, 3000, rk._PAD, out_dtype)
    assert torch.equal(out[:, :, 3000:6000], out[:, :, :3000])
    assert torch.equal(out[:, :, 6000:], out[:, :, :rk._PAD - 3000])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_span_gather_kernel(dev, packed, dtype):
    x = torch.rand((1500, 3), generator=_gen(dev, 5), device=dev)
    base_t, frac_t = base_and_frac_t(SPEC, x)
    sk, perm = torch.sort(base_t, dim=-1, stable=True)
    if packed:
        f = torch.gather(sg.pack_frac_t(frac_t), 1, perm)[:, None, :].contiguous()
    else:
        f = torch.gather(frac_t, 2, perm[:, None, :].expand(L, 3, 1500)).contiguous()
    table = torch.randn((L, S, C), generator=_gen(dev, 6), device=dev)
    R = rk.roll_broadcast_fm(table, SPEC, dtype)
    out = sg.span_gather_sorted(sk, f, R, input_dim=3)
    ref = sg.span_gather_sorted_plain(sk, f, R, input_dim=3)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_sorted_encode_on_card_matches_cpu(dev):
    """The whole encoder on the card (kernels) vs on the CPU (plain)."""
    x = torch.rand((1500, 3), generator=_gen(dev, 7), device=dev)
    table = torch.randn((L, S, C), generator=_gen(dev, 8), device=dev)
    ct = torch.randn((1500, SPEC.output_dim), generator=_gen(dev, 9), device=dev)
    outs, grads = [], []
    for d in (dev, torch.device("cpu")):
        t = table.detach().to(d).clone().requires_grad_(True)
        o = sg.sorted_encode(x.to(d), t, SPEC, torch.bfloat16, True)
        (o * ct.to(d)).sum().backward()
        outs.append(o.detach().cpu())
        grads.append(t.grad.cpu())
    torch.testing.assert_close(outs[0], outs[1], atol=1e-6, rtol=2 ** -7)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=1e-5)


def test_wrapper_checks_raise(dev):
    table = torch.randn((L, S, C), device=dev)
    with pytest.raises(ValueError, match="float32"):
        rk.roll_broadcast_fm(table.double(), SPEC, torch.bfloat16)
    keys, frac, grads = _stream(dev, 256, 10)
    with pytest.raises(ValueError, match="int32"):
        bm.bucket_grad_matmul(keys.long(), frac, grads, table_size=S, input_dim=3)
    with pytest.raises(ValueError, match="contiguous"):
        bm.bucket_grad_matmul(keys, frac.transpose(0, 1).contiguous().transpose(0, 1),
                              grads, table_size=S, input_dim=3)
    assert np.isfinite(table.sum().item())


@pytest.fixture
def wrap_offsets(monkeypatch):
    """Set every spec's corner offsets to ones at the wrap: corner 0 at 0,
    the last at S - 8 and the others at S - 1 (the offsets are cached on the
    card per spec by ``coherent_hash._offsets_on``, which reads that
    module's ``corner_offsets``, so the cache is cleared around the test)."""
    def offsets(spec):
        K = 1 << spec.input_dim
        offs = np.full((spec.num_levels, K), spec.table_size - 1, np.int32)
        offs[:, 0] = 0
        offs[:, -1] = spec.table_size - 8
        return offs

    ch._offsets_on.cache_clear()
    monkeypatch.setattr(ch, "corner_offsets", offsets)
    monkeypatch.setattr(rk, "corner_offsets", offsets)
    monkeypatch.setattr(sg, "corner_offsets", offsets)
    yield
    ch._offsets_on.cache_clear()


def _wrap_stream(dev, spec, B, seed, packed):
    """Sorted keys [L, B] with the last ones in the table's last 8 columns,
    and fracs [L, D, B] f32 or packed [L, 1, B] int32."""
    g = _gen(dev, seed)
    Ls, S_ = spec.num_levels, spec.table_size
    keys = torch.randint(0, S_, (Ls, B), generator=g, device=dev, dtype=torch.int32)
    n = min(B, 16)
    keys[:, B - n:] = torch.randint(S_ - 8, S_, (Ls, n), generator=g, device=dev,
                                    dtype=torch.int32)
    keys, _ = torch.sort(keys, dim=1)
    frac = torch.rand((Ls, spec.input_dim, B), generator=g, device=dev)
    if packed:
        frac = sg.pack_frac_t(frac)[:, None, :].contiguous()
    return keys, frac


def _table_equals_rolled(dev, spec, B, dtype, packed, table):
    keys, frac = _wrap_stream(dev, spec, B, 40, packed)
    n0 = _build.LAUNCHES["span_gather_sorted[table]"]
    out = sg.span_gather_sorted_table(keys, frac, table, spec, dtype)
    assert _build.LAUNCHES["span_gather_sorted[table]"] == n0 + 1
    rolled = sg.span_gather_sorted(keys, frac, rk.roll_broadcast_fm(
        table.contiguous(), spec, dtype), input_dim=spec.input_dim)
    assert out.shape == (spec.num_levels, table.shape[2], B)
    assert torch.equal(out, rolled)
    torch.testing.assert_close(out, sg.span_gather_sorted_table_plain(
        keys, frac, table, spec, dtype), atol=1e-5, rtol=0)


@pytest.mark.parametrize("offsets", ["spec", "wrap"])
@pytest.mark.parametrize("log2_size", [14, 19])
@pytest.mark.parametrize("dtype,packed,D", [
    (torch.bfloat16, True, 3), (torch.float32, False, 3),
    (torch.bfloat16, False, 3), (torch.float32, False, 1),
    (torch.float32, False, 2)],
    ids=["bf16_packed_d3", "f32_d3", "bf16_d3", "f32_d1", "f32_d2"])
def test_span_gather_table_mode_equals_rolled(dev, request, dtype, packed, D,
                                              log2_size, offsets):
    """The table mode is bit-equal to the rolled mode on the roll of the
    same table, and within atol 1e-5 of its plain version: B = 1507 (not a multiple of the
    256-thread block), keys in the last 8 columns, and (``wrap``) corner
    offsets of S - 1 and S - 8."""
    if offsets == "wrap":
        request.getfixturevalue("wrap_offsets")
    spec = HashGridSpec(num_levels=L, base_resolution=4, input_dim=D,
                        log2_hashmap_size=log2_size)
    table = torch.randn((L, spec.table_size, C), generator=_gen(dev, 41), device=dev)
    _table_equals_rolled(dev, spec, 1507, dtype, packed, table)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["c1", "c4", "c2_unaligned"])
def test_span_gather_table_mode_channels_and_alignment(dev, dtype, layout):
    """Other channel counts, and a C = 2 table that starts 4 bytes past an
    8-byte boundary: both take the scalar loads in place of float2."""
    C_ = {"c1": 1, "c4": 4, "c2_unaligned": 2}[layout]
    spec = HashGridSpec(num_levels=L, base_resolution=4, level_dim=C_,
                        log2_hashmap_size=14)
    n = L * S * C_
    buf = torch.randn(n + 1, generator=_gen(dev, 42), device=dev)
    table = buf[1:] if layout == "c2_unaligned" else buf[:n]
    table = table.view(L, S, C_)
    assert (table.data_ptr() % 8 != 0) == (layout == "c2_unaligned")
    _table_equals_rolled(dev, spec, 1507, dtype, False, table)


@pytest.mark.parametrize("packed", [False, True])
def test_span_gather_table_mode_empty_stream(dev, packed):
    keys, frac = _wrap_stream(dev, SPEC, 0, 43, packed)
    table = torch.randn((L, S, C), generator=_gen(dev, 44), device=dev)
    out = sg.span_gather_sorted_table(keys, frac, table, SPEC, torch.bfloat16)
    torch.cuda.synchronize()
    assert out.shape == (L, C, 0)


@pytest.mark.parametrize("placement", ["aligned", "offset_one_row"])
@pytest.mark.parametrize("C_", [1, 2, 4])
@pytest.mark.parametrize("N", [0, 1, 3, 4, 5, 1027])
def test_scatter_level_kernel_short_and_unaligned(dev, N, C_, placement):
    """Short streams (none, one, a partial block) and payloads and indices
    one row past a 16-byte boundary: bit-equal on integer payloads,
    rtol/atol 1e-5 on normal ones."""
    g = _gen(dev, 45)
    S_, shift = 64, (1 if placement == "offset_one_row" else 0)
    idx_buf = torch.randint(0, S_, (N + 1,), generator=g, device=dev,
                            dtype=torch.int32)
    ipay_buf = torch.randint(-50, 50, ((N + 1) * C_,), generator=g, device=dev).float()
    npay_buf = torch.randn(((N + 1) * C_,), generator=g, device=dev)
    idx = idx_buf[shift:shift + N]
    for buf in (ipay_buf, npay_buf):
        pay = buf[shift * C_:(shift + N) * C_].view(N, C_)
        if N:
            assert (pay.data_ptr() % 16 == 0) == (shift == 0 or C_ == 4)
        out = sl.scatter_level(idx, pay, S_)
        ref = sl.scatter_level_plain(idx, pay, S_)
        if buf is ipay_buf:
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_scatter_level_kernel_skips_out_of_range(dev):
    """Indices outside [0, S) are skipped, in a stream that is not a
    multiple of the 256-thread block."""
    g = _gen(dev, 46)
    idx = torch.randint(0, 256, (1027,), generator=g, device=dev, dtype=torch.int32)
    idx[::5] = -1
    idx[1::7] = 256
    pay = torch.randint(-9, 9, (1027, 2), generator=g, device=dev).float()
    keep = (idx >= 0) & (idx < 256)
    assert torch.equal(sl.scatter_level(idx, pay, 256),
                       sl.scatter_level_plain(idx[keep], pay[keep], 256))


def test_launch_path_raises_on_kernel_error(dev):
    """The launch path keeps each configured C entry, and a non-zero return
    raises on every call, the cached ones too."""
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    pay = torch.zeros((8, 3), device=dev)
    out = torch.empty((16, 3), device=dev)
    for _ in range(2):   # C = 3 is refused by the C entry itself
        with pytest.raises(RuntimeError, match="scatter_level.cu failed"):
            _build.launch("nvr_scatter_level", dev, idx.data_ptr(), pay.data_ptr(),
                          out.data_ptr(), 3, 8, 16)
    assert "nvr_scatter_level" in _build._entries
    keys = torch.zeros((L, 4), dtype=torch.int32, device=dev)
    frac = torch.zeros((L, 3, 4), device=dev)
    table = torch.zeros((L, 3000, C), device=dev)
    offs = torch.zeros((L, 8), dtype=torch.int32, device=dev)
    fout = torch.empty((L, C, 4), device=dev)
    with pytest.raises(RuntimeError, match="span_gather.cu failed"):
        # S = 3000 is not a power of two: refused by the table entry
        _build.launch("nvr_span_gather_table", dev, keys.data_ptr(), frac.data_ptr(),
                      table.data_ptr(), offs.data_ptr(), fout.data_ptr(), 0, 0, L,
                      3, C, 4, 3000)
    torch.cuda.synchronize()


# ---- the data side on the card: the projector and the generator ----

@pytest.mark.parametrize("mode,tilt", [("cone", 0.0), ("parallel", 29.0)])
def test_project_angles_on_card_matches_cpu(dev, mode, tilt):
    """The projector on the card (its default) against the same function
    on the CPU: the same f32 operations, the per-ray sums in another order
    (atol 1e-5 of the largest value)."""
    from neuralvolumetricreconstructionformedicalimages_torch import geometry as G
    from neuralvolumetricreconstructionformedicalimages_torch.data.projector import (
        project_angles)

    geo = G.ConeGeometry(DSD=1.5, DSO=1.0, nDetector=(24, 17), dDetector=(0.01, 0.01),
                         nVoxel=(16, 16, 16), dVoxel=(0.008, 0.008, 0.008),
                         mode=mode, tilt_angle=tilt)
    vol = np.random.default_rng(0).random(geo.nVoxel).astype(np.float32)
    angles = np.array([0.1, 1.3, 4.0], np.float32)
    card = project_angles(vol, geo, angles)
    assert card.device.type == "cuda" and card.shape == (3, 17, 24)
    cpu = project_angles(vol, geo, angles, device="cpu")
    top = float(cpu.abs().max())
    assert top > 0.01
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-5 * top)


def test_generate_runs_on_card(dev):
    """``generate`` with no device projects on the card; the dataset
    matches the CPU's (angles and volume equal, projections within 1e-5
    of the largest value)."""
    import importlib

    gen = importlib.import_module(
        "neuralvolumetricreconstructionformedicalimages_torch.data.generate")
    scan = {"nVoxel": [16, 16, 8], "dVoxel": [8.0, 8.0, 8.0], "nDetector": [16, 17],
            "dDetector": [12.0, 12.0], "numTrain": 3, "numVal": 2, "mode": "parallel",
            "tilt_angle": 29, "totalAngle": 360}
    card = gen.generate(scan, phantom="lamino_chip", seed=0)
    cpu = gen.generate(scan, phantom="lamino_chip", seed=0, device="cpu")
    np.testing.assert_array_equal(card["image"], cpu["image"])
    for split in ("train", "val"):
        np.testing.assert_array_equal(card[split]["angles"], cpu[split]["angles"])
        a, b = card[split]["projections"], cpu[split]["projections"]
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()))


# ---- the training step captured as a CUDA graph (train/trainer.py) ----

_SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "data", "smoke.pickle")
# the main-path kernels: launched once a step (True) or never (False)
_GRAPH_PATHS = {
    "sorted": ({}, {"span_gather_sorted[table]": True, "bucket_grad_matmul": True,
                    "unroll_reduce_fm": True, "span_gather_sorted": False,
                    "roll_broadcast_fm": False}),
    "rolled": ({"forward": "rolled", "input_grads": True},
               {"roll_broadcast_fm": True, "bucket_grad_matmul": True,
                "unroll_reduce_fm": True, "span_gather_sorted[table]": False}),
    "xor": ({"hash_variant": "xor"},
            {"bucket_grad_matmul": True, "unroll_reduce_fm": False,
             "span_gather_sorted[table]": False}),
}


def _small_cfg(encoder=None, n_batch=1):
    """The main-path encoder at 3 levels x 2^14, 64 rays x 32 samples, on
    the smoke scan."""
    from neuralvolumetricreconstructionformedicalimages_torch.config import with_defaults

    return with_defaults({
        "exp": {"expname": "g", "expdir": ".", "datadir": _SMOKE},
        "network": {"net_type": "mlp", "num_layers": 4, "hidden_dim": 16,
                    "skips": [2], "out_dim": 1, "last_activation": "sigmoid",
                    "bound": 0.3},
        "encoder": {"encoding": "hashgrid", "input_dim": 3, "num_levels": 3,
                    "level_dim": 2, "base_resolution": 8, "log2_hashmap_size": 14,
                    "forward": "sorted", "table_dtype": "bfloat16",
                    "pack_sort": True, **(encoder or {})},
        "render": {"n_samples": 32, "n_fine": 0, "perturb": True,
                   "raw_noise_std": 0.0, "netchunk": 4096},
        "train": {"epoch": 1, "n_batch": n_batch, "n_rays": 64, "lrate": 1e-2,
                  "lrate_gamma": 0.1, "lrate_step": 10, "resume": False},
        "log": {"i_eval": 0, "i_save": 0}})


def _epoch_parts(dev, encoder, seed=0):
    """A small field (:func:`_small_cfg`), its capturable optimizer and
    generator, and the epoch function and the eager step over them."""
    from neuralvolumetricreconstructionformedicalimages_torch.data.dataset import (
        load_dataset)
    from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as T
    from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
        make_optimizer)

    cfg = _small_cfg(encoder)
    T.pin_fp32()
    ds = load_dataset(_SMOKE, "train", 64, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    field = T.build_model(cfg, g, dev)
    opt = make_optimizer(cfg, field.parameters())
    kw = dict(n_rays=64, n_batch=1, use_mask=False, generator=g, geo=ds.geo,
              near=ds.near, far=ds.far)
    return (ds.arrays(), field, T.make_epoch_fn(cfg, field, opt, 10, **kw),
            T.make_train_step(cfg, field, opt, **kw), opt)


@pytest.mark.parametrize("path", sorted(_GRAPH_PATHS))
def test_graphed_steps_equal_eager_steps(dev, path):
    """One eager step, a capture and 4 replays of the epoch function: the
    replays make no host sync (``set_sync_debug_mode("error")``), every
    kernel of the path launched once a step by the replay-aware counts,
    and the losses and parameters ``torch.equal`` to 5 eager steps of
    ``make_train_step`` from the same seed."""
    from neuralvolumetricreconstructionformedicalimages_torch.train.optim import set_lr

    enc, needs = _GRAPH_PATHS[path]
    order = torch.arange(5, device=dev)[:, None]
    arrays, field, epoch_fn, _, _ = _epoch_parts(dev, enc)
    _build.reset_launches()
    first = epoch_fn(arrays, order[:1], 0)           # the eager step and the capture
    graph = epoch_fn.graphed.graph
    assert graph is not None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rest = epoch_fn(arrays, order[1:], 1)         # replays only
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert epoch_fn.graphed.graph is graph            # kept, not captured again
    launches = dict(_build.LAUNCHES)
    for kname, every_step in needs.items():
        assert launches.get(kname, 0) == (5 if every_step else 0), (kname, launches)
    graphed = torch.cat([first, rest])

    arrays, field_e, _, step, opt = _epoch_parts(dev, enc)
    set_lr(opt, 1e-2)
    eager = torch.stack([step(arrays, order[i]) for i in range(5)])
    assert torch.equal(graphed, eager), (graphed, eager)
    for a, b in zip(field.parameters(), field_e.parameters()):
        assert torch.equal(a, b)


def test_graphed_trainer_resumes_from_checkpoint(dev, tmp_path, monkeypatch):
    """The trainer on the card checkpoints Adam's device step and rate with
    its graphed epochs; a second trainer resumed from the checkpoint
    (eager step, capture, replays) takes the next epoch's steps
    ``torch.equal`` to the first trainer's replays."""
    import functools

    from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as T
    from neuralvolumetricreconstructionformedicalimages_torch.utils.logging import (
        ExperimentLogger)

    monkeypatch.setattr(T, "ExperimentLogger",
                        functools.partial(ExperimentLogger, enable_tensorboard=False))
    cfg = _small_cfg(n_batch=2)
    cfg["log"]["i_save"] = 1
    a = T.Trainer(cfg, workdir=str(tmp_path), device=dev)
    a.start()                                   # epochs 0 and 1; saves epoch 1
    assert a.optimizer.param_groups[0]["capturable"]
    assert all(st["step"].is_cuda for st in a.optimizer.state.values())
    cfg["train"]["resume"] = True
    b = T.Trainer(cfg, workdir=str(tmp_path), device=dev)
    assert b.epoch_start == 2 and b.global_step == a.global_step
    order = torch.as_tensor(a._view_order(2), device=dev)
    la, lb = a.train_steps(order), b.train_steps(order)
    assert torch.equal(la, lb), (la, lb)
    for p, q in zip(a._parameters(), b._parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("plain_on", ["cuda", "cpu"])
def test_capturable_adam_matches_plain_adam(dev, plain_on):
    """``make_optimizer``'s Adam on the card (capturable, the rate a device
    tensor filled by ``set_lr``) against a plain float-rate Adam -- the one
    the CPU tests hold against JAX's optax Adam -- on the same parameters
    and gradients, over 3 steps whose last one runs at a tenth of the rate.
    After step k the parameters agree to k * 1e-3 * lr where every
    gradient is well above eps (100 eps), and to k * 2 * lr elsewhere
    (``tests/test_torch_train.py``'s one-step tolerances, summed over the
    steps)."""
    from neuralvolumetricreconstructionformedicalimages_torch.train.optim import (
        make_optimizer, set_lr)

    lr, eps = 1e-2, 1e-8
    cfg = {"train": {"lrate": lr}}
    rng = np.random.default_rng(0)
    shapes = [(3, 1 << 12, 2), (16, 16), (16,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1, s)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    ours = [torch.nn.Parameter(torch.from_numpy(x).to(dev)) for x in init]
    ref = [torch.nn.Parameter(torch.from_numpy(x).to(plain_on)) for x in init]
    opt = make_optimizer(cfg, ours)
    assert opt.param_groups[0]["capturable"]
    assert isinstance(opt.param_groups[0]["lr"], torch.Tensor)
    plain = torch.optim.Adam(ref, lr=lr, betas=(0.9, 0.999), eps=eps)
    big = [np.ones(s, bool) for s in shapes]
    for k, (g_k, rate) in enumerate(zip(grads, (lr, lr, lr / 10)), start=1):
        set_lr(opt, rate)
        set_lr(plain, rate)
        for p, q, g in zip(ours, ref, g_k):
            p.grad = torch.from_numpy(g).to(dev)
            q.grad = torch.from_numpy(g).to(plain_on)
        opt.step()
        plain.step()
        big = [b & (np.abs(g) > 100 * eps) for b, g in zip(big, g_k)]
        for p, q, b in zip(ours, ref, big):
            diff = (p.detach().cpu() - q.detach().cpu()).abs().numpy()
            assert diff[b].max(initial=0.0) <= k * 1e-3 * lr, (k, diff[b].max())
            assert diff.max() <= k * 2 * lr, (k, diff.max())


def test_force_mesh_matches_plain_trainer_on_card(dev, tmp_path, monkeypatch):
    """A mesh of one (a one-rank NCCL group) and the plain trainer, both
    eager, at two views a step: the same losses and parameters, bit for
    bit, over 6 steps.  Both steps draw their pixels with one
    ``gather_batch`` draw of [n_batch, n_rays], which on the card is not
    the per-view draws of ``gather_view_batch``."""
    import functools

    import _parallel_ranks as R
    import torch.distributed as dist

    from neuralvolumetricreconstructionformedicalimages_torch.parallel import mesh as tmesh
    from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as T
    from neuralvolumetricreconstructionformedicalimages_torch.utils.logging import (
        ExperimentLogger)

    monkeypatch.setattr(T, "ExperimentLogger",
                        functools.partial(ExperimentLogger, enable_tensorboard=False))
    monkeypatch.setattr(tmesh, "DEFAULT_TIMEOUT_S", R.GROUP_TIMEOUT_S)
    assert not dist.is_initialized()
    runs = R.force_mesh_runs(tmp_path, dev, n_batch=2)
    assert not dist.is_initialized()
    assert torch.equal(runs["mesh"][0], runs["plain"][0]), runs
    for a, b in zip(runs["mesh"][1].parameters(), runs["plain"][1].parameters()):
        assert torch.equal(a, b)
