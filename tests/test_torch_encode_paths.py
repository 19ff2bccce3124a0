"""Port parity of the encoder paths beside the sorted main path: the
coherent rolled path (``coherent_encode``: roll kernel, bucket kernel into
the table dtype, bf16-capable unroll, analytic position gradients), the
take path (``coherent_encode_takevjp``: autograd through a differentiable
rolled build) and the XOR variant (``hash_grid_indices``, ``hash_encode``,
``hash_encode_fast`` with the bucket kernel at D=0) -- each against the
JAX package on the same numpy inputs, with JAX's Pallas kernels in
interpret mode (``log2_hashmap_size=14``) -- and the ``HashEncoderSpec``
dispatch over the whole knob grid.

Tolerances, with their reasons:

- features: the same f32 trilerp of the same (f32 or bf16) table values,
  atol 1e-5: XLA may fuse ``x * scale + 0.5`` into one multiply-add, which
  moves the in-cell position by an ulp of ``pos`` (up to ~2e-6 at scale 31)
  and the features by that times |table| (N(0,1) values);
- f32 table gradients: vs JAX's Pallas bucket kernel atol 3e-4, its
  two-pass bf16 payload split (JAX ``bucket_matmul.py:160-169``); vs JAX's
  autodiff oracle atol 2e-5, both exact f32 sums of the same products;
- bf16 table gradients: both frameworks round the rolled gradient (or,
  on the take path, every scatter-add) to bf16, and a different f32 sum
  can round to the neighbouring bf16 value: one bf16 ulp of the largest
  partial sum (2^-8 of max |grad|) against JAX's own bf16 path;
- position gradients: f32 einsums of the same values, rtol/atol 2e-4 (as
  JAX's own XOR test holds them): with N(0,1) tables they reach ~100
  (scale up to 31 times sums of table values), and the in-cell position
  that an FMA moves by ~2e-6 moves them by ~1e-5 relative.
"""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu.models.encoders import (  # noqa: E402
    HashEncoderSpec as JEnc,
)
from neuralvolumetricreconstructionformedicalimages_tpu.ops import coherent_hash as jch  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops import hash_encoding as jhe  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as JSpec,
)
from neuralvolumetricreconstructionformedicalimages_torch.models.encoders import (  # noqa: E402
    HashEncoderSpec as TEnc,
)
from neuralvolumetricreconstructionformedicalimages_torch.ops import coherent_hash as tch  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import hash_encoding as the  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as TSpec,
)

# dense levels (res 8, 16) and a hashed one (res 32); 2^14 % 4096 == 0
# takes JAX's Pallas paths
KW = dict(num_levels=3, base_resolution=8, log2_hashmap_size=14)
JS, TS = JSpec(**KW), TSpec(**KW)
TABLE = np.random.default_rng(11).normal(size=(3, 1 << 14, 2)).astype(np.float32)


def _points(case):
    rng = np.random.default_rng(12)
    if case == "identical500":   # tests/test_coherent_hash.py:124
        return np.concatenate([np.full((500, 3), 0.375, np.float32),
                               rng.uniform(0, 1, (12, 3)).astype(np.float32)])
    if case == "dup4x80":        # tests/test_hash_encoding.py:198
        return np.repeat(rng.uniform(0, 1, (4, 3)).astype(np.float32), 80, axis=0)
    return rng.uniform(0, 1, (int(case), 3)).astype(np.float32)


def _ct(B, dim):
    return np.random.default_rng(13).normal(size=(B, dim)).astype(np.float32)


def _jax_all(fn, x, table, ct):
    """JAX features and the gradients of <features, ct> wrt positions and
    table, one jitted call."""
    def both(xx, tb):
        out, vjp = jax.vjp(fn, xx, tb)
        gx, gt = vjp(jnp.asarray(ct))
        return out, gx, gt
    out, gx, gt = jax.jit(both)(jnp.asarray(x), jnp.asarray(table))
    return tuple(np.asarray(a, np.float32) for a in (out, gx, gt))


def _torch_all(fn, x, table, ct, x_grad=True):
    xt = torch.as_tensor(x).requires_grad_(x_grad)
    tt = torch.as_tensor(table).requires_grad_(True)
    out = fn(xt, tt)
    (out * torch.as_tensor(ct)).sum().backward()
    gx = xt.grad.numpy() if x_grad else None
    return out.detach().numpy(), gx, tt.grad.numpy()


def _bf16_atol(g):
    """One bf16 ulp of the largest partial sum (see the module docstring)."""
    return 2.0 ** -8 * float(np.abs(g).max())


@pytest.mark.parametrize("case", ["700", "identical500"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coherent_encode_matches_jax(case, dtype):
    x = _points(case)
    ct = _ct(x.shape[0], JS.output_dim)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jgx, jgt = _jax_all(lambda a, t: jch.coherent_encode(a, t, JS, jd),
                              x, TABLE, ct)
    tout, tgx, tgt = _torch_all(lambda a, t: tch.coherent_encode(a, t, TS, td),
                                x, TABLE, ct)
    assert tout.shape == (x.shape[0], JS.output_dim)
    np.testing.assert_allclose(tout, jout, atol=1e-5)
    np.testing.assert_allclose(tgx, jgx, rtol=2e-4, atol=2e-4)
    if dtype == "float32":
        np.testing.assert_allclose(tgt, jgt, atol=3e-4)
        _, rgx, rgt = _jax_all(lambda a, t: jch.coherent_encode_reference(a, t, JS),
                               x, TABLE, ct)
        np.testing.assert_allclose(tgt, rgt, atol=2e-5)
        np.testing.assert_allclose(tgx, rgx, rtol=2e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(tgt, jgt, atol=_bf16_atol(jgt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coherent_encode_takevjp_matches_jax(dtype):
    x = _points("700")
    ct = _ct(x.shape[0], JS.output_dim)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jgx, jgt = _jax_all(
        lambda a, t: jch.coherent_encode_takevjp(a, t, JS, jd), x, TABLE, ct)
    tout, tgx, tgt = _torch_all(
        lambda a, t: tch.coherent_encode_takevjp(a, t, TS, td), x, TABLE, ct)
    np.testing.assert_allclose(tout, jout, atol=1e-5)
    np.testing.assert_allclose(tgx, jgx, rtol=2e-4, atol=2e-4)
    if dtype == "float32":
        np.testing.assert_allclose(tgt, jgt, atol=2e-5)
        _, _, rgt = _jax_all(lambda a, t: jch.coherent_encode_reference(a, t, JS),
                             x, TABLE, ct)
        np.testing.assert_allclose(tgt, rgt, atol=2e-5)
    else:
        np.testing.assert_allclose(tgt, jgt, atol=_bf16_atol(jgt))


def test_coherent_encode_without_position_grads():
    """Positions that need no gradient skip the analytic einsums; the
    table gradient is the same."""
    x = _points("700")
    ct = _ct(700, JS.output_dim)
    fn = lambda a, t: tch.coherent_encode(a, t, TS)  # noqa: E731
    _, gx, g_with = _torch_all(fn, x, TABLE, ct)
    _, none, g_without = _torch_all(fn, x, TABLE, ct, x_grad=False)
    assert gx is not None and none is None
    np.testing.assert_array_equal(g_with, g_without)


def test_corner_weight_grads_match():
    f = np.random.default_rng(14).uniform(0, 1, (200, 3, 3)).astype(np.float32)
    f[0, 0] = [0.0, 1.0, 0.5]
    j = np.asarray(jch.corner_weight_grads(JS, jnp.asarray(f)))
    t = tch.corner_weight_grads(TS, torch.as_tensor(f)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-7)
    # the XOR backward's copy in JAX is the same function; the port has one
    np.testing.assert_allclose(
        t, np.asarray(jhe._corner_weight_grads_xor(JS, jnp.asarray(f))), atol=1e-7)


@pytest.mark.parametrize("kw", [KW, dict()], ids=["small", "full"])
def test_hash_grid_indices_bit_exact(kw):
    """XOR-hash and dense indices equal JAX's int32-wraparound ones bit for
    bit (the full spec: 16 levels x 2^19, fine levels hashed)."""
    js, ts = JSpec(**kw), TSpec(**kw)
    x = np.random.default_rng(15).uniform(0, 1, (2048, 3)).astype(np.float32)
    x[:3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.99999994, 0.5, 0.0]]
    jidx, jw = jhe.hash_grid_indices(js, jnp.asarray(x))
    tidx, tw = the.hash_grid_indices(ts, torch.as_tensor(x))
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)
    _, _, jf = jhe._indices_weights_frac(js, jnp.asarray(x))
    _, _, tf = the._indices_weights_frac(ts, torch.as_tensor(x))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)


@pytest.mark.parametrize("case", ["257", "dup4x80"])
@pytest.mark.parametrize("fn", ["hash_encode", "hash_encode_fast"])
def test_xor_encode_matches_jax_oracle(fn, case):
    """Against JAX's autodiff oracle, including the 4 x 80 duplicate-heavy
    points that JAX's own fast path misses (2.48e-5 > 2e-5): the port sums
    each key's run exactly, in stream order."""
    x = _points(case)
    ct = _ct(x.shape[0], JS.output_dim)
    jout, jgx, jgt = _jax_all(lambda a, t: jhe.hash_encode(a, t, JS), x, TABLE, ct)
    tfn = getattr(the, fn)
    tout, tgx, tgt = _torch_all(lambda a, t: tfn(a, t, TS), x, TABLE, ct)
    np.testing.assert_allclose(tout, jout, atol=1e-5)
    np.testing.assert_allclose(tgt, jgt, atol=2e-5)
    np.testing.assert_allclose(tgx, jgx, rtol=2e-4, atol=2e-4)


def test_xor_fast_matches_jax_fast():
    """hash_encode_fast against JAX's (Pallas bucket at D=0, interpret)."""
    x = _points("257")
    ct = _ct(257, JS.output_dim)
    jout, jgx, jgt = _jax_all(lambda a, t: jhe.hash_encode_fast(a, t, JS),
                              x, TABLE, ct)
    tout, tgx, tgt = _torch_all(lambda a, t: the.hash_encode_fast(a, t, TS),
                                x, TABLE, ct)
    np.testing.assert_allclose(tout, jout, atol=1e-5)
    np.testing.assert_allclose(tgt, jgt, atol=3e-4)
    np.testing.assert_allclose(tgx, jgx, rtol=2e-4, atol=2e-4)


_GRID = list(itertools.product(["coherent", "xor"], [True, False],
                               ["sorted", "rolled"], ["bucket", "take"],
                               [False, True], [14, 9]))


@pytest.mark.parametrize("variant,fast,forward,backward,input_grads,log2", _GRID)
def test_encoder_spec_dispatch_all_paths(variant, fast, forward, backward,
                                         input_grads, log2):
    """HashEncoderSpec.apply takes JAX's path for every knob combination
    (no NotImplementedError): features, table gradients and, where the path
    gives them, position gradients match JAX's ``HashEncoderSpec.apply``.
    f32 payloads; tolerances of the module docstring, widest of the paths
    (the Pallas split's 3e-4 on table gradients)."""
    kw = dict(num_levels=3, base_resolution=4 if log2 == 9 else 8,
              log2_hashmap_size=log2)
    knobs = dict(hash_variant=variant, fast=fast, forward=forward,
                 backward=backward, input_grads=input_grads, pack_sort=False)
    jenc, tenc = JEnc(grid=JSpec(**kw), **knobs), TEnc(grid=TSpec(**kw), **knobs)
    sorted_path = (variant == "coherent" and fast and backward == "bucket"
                   and forward == "sorted" and not input_grads and log2 == 14)
    x = np.random.default_rng(16).uniform(-0.25, 0.25, (97, 3)).astype(np.float32)
    table = np.random.default_rng(17).normal(
        size=(3, 1 << log2, 2)).astype(np.float32)
    ct = _ct(97, jenc.output_dim)
    jout, jgx, jgt = _jax_all(lambda a, t: jenc.apply({"table": t}, a, 0.2),
                              x, table, ct)
    tout, tgx, tgt = _torch_all(lambda a, t: tenc.apply({"table": t}, a, 0.2),
                                x, table, ct, x_grad=not sorted_path)
    np.testing.assert_allclose(tout, jout, atol=1e-5)
    np.testing.assert_allclose(tgt, jgt, atol=3e-4)
    if not sorted_path:
        np.testing.assert_allclose(tgx, jgx, rtol=2e-4, atol=2e-4)


def test_encoder_spec_unknown_variant_raises():
    enc = TEnc(grid=TS, hash_variant="nope")
    with pytest.raises(NotImplementedError, match="nope"):
        enc.apply({"table": torch.as_tensor(TABLE)}, torch.zeros(8, 3), 0.2)
