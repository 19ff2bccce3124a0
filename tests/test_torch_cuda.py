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
