"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a card (the
decision is taken inside the fixture, so every worker collects the same
tests).  This file imports neither JAX nor the JAX package, so it runs on
a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: rolls are copies (bit-equal); the span gather and the unroll
reduce (f32 or bf16 input) take the same f32 operations in the same order
as the plain versions, up to the plain versions' own kernels (atol 1e-5);
the bucket sum is bitwise reproducible run to run, and equals the plain
version bit for bit (both sum every run in stream order from the same f32
products); the scatter's atomics add in no fixed order (rtol/atol 1e-5 on
normal payloads, bit-equal on integer-valued ones, which sum exactly).
"""

import dataclasses

import numpy as np
import pytest
import torch

from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
from neuralvolumetricreconstructionformedicalimages_torch.ops import bucket_matmul as bm
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
