"""Port parity of the four encoder kernels (their plain PyTorch versions,
which the wrappers run for CPU tensors) against the JAX package's Pallas
kernels, run off the TPU in interpret mode as the JAX tests run them.

The spec is 5 levels x 2^14 x 2 (``2^14 % 4096 == 0`` sends JAX down its
Pallas paths).  Tables and gradients are N(0,1), so tolerances are
meaningful.  Tolerances, with their reasons:

- rolls are copies: bit-exact in f32 and bf16;
- the unroll reduce sums 8 f32 values in the same k order: atol 1e-5;
- the bucket sum against JAX's exact scatter-add oracle: both are
  sequential f32 sums of the same products, rtol/atol 1e-5; against the
  Pallas kernel atol 3e-4, the kernel's two-pass bf16 payload split error
  (JAX ``bucket_matmul.py:160-169``);
- the span gather against the Pallas kernel (exact one-hot selection,
  same weight and corner order): atol 1e-5.

The whole encoder around them is held in ``test_torch_encode.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu.ops import bucket_matmul as jbm  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops import roll_kernels as jrk  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops import span_gather as jsg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as JSpec,
)
from neuralvolumetricreconstructionformedicalimages_torch.ops import bucket_matmul as tbm  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import roll_kernels as trk  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as tsg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as TSpec,
)

KW = dict(num_levels=5, base_resolution=4, log2_hashmap_size=14)
JS, TS = JSpec(**KW), TSpec(**KW)
L, S, C = 5, 1 << 14, 2


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _table(seed):
    return np.random.default_rng(seed).normal(size=(L, S, C)).astype(np.float32)


def _stream(seed, B, D=3, dup=False):
    """Sorted keys [L, B] (with duplicates), fracs [L, D, B], grads [L, C, B]."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, S, (L, B)), axis=1).astype(np.int32)
    if dup:
        keys[:, : B // 2] = 77  # one column owns half of the stream
        keys = np.sort(keys, axis=1)
    frac = rng.uniform(0, 1, (L, D, B)).astype(np.float32)
    grads = rng.normal(size=(L, C, B)).astype(np.float32)
    return keys, frac, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roll_broadcast_bit_exact(dtype):
    table = _table(0)
    j = jax.jit(lambda a: jrk.roll_broadcast_fm(a, JS, getattr(jnp, dtype)))(
        jnp.asarray(table))
    t = trk.roll_broadcast_fm(torch.as_tensor(table), TS, getattr(torch, dtype))
    assert t.dtype == getattr(torch, dtype) and t.shape == (L, 8 * C, S)
    np.testing.assert_array_equal(t.float().numpy(), _f32(j))
    r = tsg.roll_broadcast_reference(torch.as_tensor(table), TS, getattr(torch, dtype))
    assert torch.equal(r, t)


def test_unroll_reduce_matches():
    G = np.random.default_rng(1).normal(size=(L, 8 * C, S)).astype(np.float32)
    j = jax.jit(lambda g: jrk.unroll_reduce_fm(jrk.wrap_extend(g, jrk._PAD), JS, C))(
        jnp.asarray(G))
    ext = trk.wrap_extend(torch.as_tensor(G), trk._PAD)
    assert ext.shape == (L, 8 * C, S + trk._PAD)
    t = trk.unroll_reduce_fm(ext, TS, C)
    np.testing.assert_allclose(t.numpy(), _f32(j), atol=1e-5)
    np.testing.assert_allclose(
        tsg.unroll_reduce_reference(torch.as_tensor(G), TS).numpy(),
        _f32(jsg.unroll_reduce_reference(jnp.asarray(G), JS)), atol=1e-5)


@pytest.mark.parametrize("dup", [False, True], ids=["random", "duplicate_heavy"])
def test_bucket_matches_oracle_and_pallas(dup):
    keys, frac, grads = _stream(2, 3000, dup=dup)
    tk, tf, tg = map(torch.as_tensor, (keys, frac, grads))
    t = tbm.bucket_grad_matmul(tk, tf, tg, table_size=S, input_dim=3,
                               extend_cols=trk._PAD)
    assert t.shape == (L, 8 * C, S + trk._PAD) and t.dtype == torch.float32
    ref = _f32(jbm.bucket_grad_matmul_reference(
        jnp.asarray(keys), jnp.asarray(frac), jnp.asarray(grads),
        table_size=S, input_dim=3))
    np.testing.assert_allclose(t[..., :S].numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t[..., S:].numpy(), t[..., : trk._PAD].numpy())
    pallas = _f32(jax.jit(lambda *a: jbm.bucket_grad_matmul(
        *a, table_size=S, input_dim=3, extend_cols=jrk._PAD))(
            jnp.asarray(keys), jnp.asarray(frac), jnp.asarray(grads)))
    np.testing.assert_allclose(t.numpy(), pallas, atol=3e-4)
    tr = tbm.bucket_grad_matmul_reference(tk, tf, tg, table_size=S, input_dim=3)
    np.testing.assert_allclose(tr.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_bucket_no_fracs_and_bf16_output():
    """input_dim=0 (weight 1, the XOR backward's use) and a bf16 output."""
    keys, _, grads = _stream(3, 2048)
    frac0 = np.zeros((L, 0, 2048), np.float32)
    t = tbm.bucket_grad_matmul(torch.as_tensor(keys), torch.as_tensor(frac0),
                               torch.as_tensor(grads), table_size=S, input_dim=0,
                               out_dtype=torch.bfloat16)
    ref = _f32(jbm.bucket_grad_matmul_reference(
        jnp.asarray(keys), jnp.asarray(frac0), jnp.asarray(grads),
        table_size=S, input_dim=0))
    assert t.dtype == torch.bfloat16 and t.shape == (L, C, S)
    np.testing.assert_allclose(t.float().numpy(), ref, rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("dtype,packed", [("float32", False), ("bfloat16", True)],
                         ids=["f32_table_f32_fracs", "bf16_table_packed_fracs"])
def test_span_gather_matches_pallas(dtype, packed):
    keys, frac, _ = _stream(4, 2048)  # the Pallas kernel needs B % 1024 == 0
    table = _table(5)
    jR = jax.jit(lambda a: jrk.roll_broadcast_fm(a, JS, getattr(jnp, dtype)))(
        jnp.asarray(table))
    tR = trk.roll_broadcast_fm(torch.as_tensor(table), TS, getattr(torch, dtype))
    if packed:
        jf = jsg.pack_frac_t(jnp.asarray(frac))[:, None, :]
        tf = torch.as_tensor(np.array(jf))
    else:
        jf, tf = jnp.asarray(frac), torch.as_tensor(frac)
    j = jax.jit(lambda k, f, r: jsg.span_gather_sorted(k, f, r, input_dim=3))(
        jnp.asarray(keys), jf, jR)
    t = tsg.span_gather_sorted(torch.as_tensor(keys), tf, tR, input_dim=3)
    assert t.shape == (L, C, 2048) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), _f32(j), atol=1e-5)


def test_sorted_encode_refuses_position_grads():
    x = torch.rand(64, 3, requires_grad=True)
    table = torch.as_tensor(_table(9))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsg.sorted_encode(x, table, TS)


def test_wrappers_raise_on_unsupported_device():
    """A tensor that is neither on the CPU nor on one CUDA device never
    reaches a plain version silently."""
    table = torch.zeros((L, S, C), device="meta")
    with pytest.raises(ValueError, match="device"):
        trk.roll_broadcast_fm(table, TS, torch.bfloat16)
