"""Port parity of the whole sorted encoder: ``sorted_encode`` (roll ->
integer sort -> span gather -> un-permute; backward sort -> bucket ->
unroll) and the ``HashEncoderSpec`` dispatch, against the JAX package's
``sorted_encode`` (Pallas kernels in interpret mode) and its autograd
oracle, at B = 700, B = 1500 and for 700 identical points.  The packed
main-path payloads are held in ``test_torch_encode_packed.py``; the other
encoder paths and the dispatch over every knob in
``test_torch_encode_paths.py``.

Tolerances, with their reasons:

- f32 payloads: features are the same f32 trilerp (atol 1e-5);
- packed payloads round features to bf16 in both; a different f32
  rounding before that can flip one bf16 ulp (rtol 2^-7);
- table gradients vs JAX's Pallas backward: atol 3e-4, its two-pass bf16
  payload split (JAX ``bucket_matmul.py:160-169``); vs the exact autograd
  oracle (f32 payloads): rtol 1e-5, atol 1e-4 for sums of up to 700
  duplicate updates.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu.models.encoders import (  # noqa: E402
    HashEncoderSpec as JEnc,
)
from neuralvolumetricreconstructionformedicalimages_tpu.ops import span_gather as jsg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops.coherent_hash import (  # noqa: E402
    coherent_encode_reference as j_reference,
)
from neuralvolumetricreconstructionformedicalimages_tpu.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as JSpec,
)
from neuralvolumetricreconstructionformedicalimages_torch.models.encoders import (  # noqa: E402
    HashEncoderSpec as TEnc,
)
from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as tsg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as TSpec,
)

# dense levels (res 8, 16) and a hashed one (res 32); 2^14 % 4096 == 0
# takes JAX's Pallas paths
KW = dict(num_levels=3, base_resolution=8, log2_hashmap_size=14)
JS, TS = JSpec(**KW), TSpec(**KW)
TABLE = np.random.default_rng(7).normal(size=(3, 1 << 14, 2)).astype(np.float32)


def _points(case):
    if case == "identical700":
        return np.full((700, 3), 0.625, np.float32)
    return np.random.default_rng(6).uniform(0, 1, (int(case), 3)).astype(np.float32)


def _jax_fwd_and_grad(fn, x, ct):
    """JAX features and d<features, ct>/d table, one jitted call."""
    def both(tb):
        out, vjp = jax.vjp(lambda t: fn(jnp.asarray(x), t), tb)
        return out, vjp(jnp.asarray(ct))[0]
    out, grad = jax.jit(both)(jnp.asarray(TABLE))
    return np.asarray(out, np.float32), np.asarray(grad, np.float32)


@pytest.mark.parametrize("case", ["700", "1500", "identical700"])
def test_sorted_encode_features_and_table_grads(case):
    """f32 rolled table and f32 payloads."""
    x = _points(case)
    B = x.shape[0]
    ct = np.random.default_rng(8).normal(size=(B, JS.output_dim)).astype(np.float32)
    jfeat, jgrad = _jax_fwd_and_grad(
        lambda xx, t: jsg.sorted_encode(xx, t, JS, jnp.float32, False), x, ct)
    _, oracle = _jax_fwd_and_grad(lambda xx, t: j_reference(xx, t, JS), x, ct)

    tt = torch.as_tensor(TABLE).requires_grad_(True)
    tfeat = tsg.sorted_encode(torch.as_tensor(x), tt, TS, torch.float32, False)
    (tfeat * torch.as_tensor(ct)).sum().backward()
    assert tfeat.shape == (B, JS.output_dim)
    np.testing.assert_allclose(tfeat.detach().numpy(), jfeat, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), jgrad, atol=3e-4)
    np.testing.assert_allclose(tt.grad.numpy(), oracle, rtol=1e-5, atol=1e-4)


def test_sorted_encode_features_function():
    """sorted_encode_features on precomputed level-major indices (B=1500)."""
    from neuralvolumetricreconstructionformedicalimages_tpu.ops.coherent_hash import (
        base_and_frac_t as jbf)
    from neuralvolumetricreconstructionformedicalimages_tpu.ops.roll_kernels import (
        roll_broadcast_fm as jroll)
    from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (
        base_and_frac_t as tbf)
    from neuralvolumetricreconstructionformedicalimages_torch.ops.roll_kernels import (
        roll_broadcast_fm as troll)

    x = _points("1500")
    jb, jf = jbf(JS, jnp.asarray(x))
    j = jax.jit(lambda b, f, t: jsg.sorted_encode_features(
        b, f, jroll(t, JS), 3, pack=False))(jb, jf, jnp.asarray(TABLE))
    tb, tf = tbf(TS, torch.as_tensor(x))
    t = tsg.sorted_encode_features(tb, tf, troll(torch.as_tensor(TABLE), TS), 3,
                                   pack=False)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_encoder_spec_dispatch():
    """HashEncoderSpec.apply: clamp to [0, 1], the sorted path for a table
    size multiple of 2048, the oracle otherwise -- as the JAX spec."""
    x = np.random.default_rng(9).uniform(-0.25, 0.25, (97, 3)).astype(np.float32)
    for kw in (KW, dict(num_levels=3, base_resolution=4, log2_hashmap_size=9)):
        jenc = JEnc(grid=JSpec(**kw), pack_sort=False)
        tenc = TEnc(grid=TSpec(**kw), pack_sort=False)
        table = np.random.default_rng(1).normal(
            size=(kw["num_levels"], 1 << kw["log2_hashmap_size"], 2)).astype(np.float32)
        j = jax.jit(lambda t: jenc.apply({"table": t}, jnp.asarray(x), 0.2))(
            jnp.asarray(table))
        t = tenc.apply({"table": torch.as_tensor(table)}, torch.as_tensor(x), 0.2)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
