"""Port parity of the whole sorted encoder in the main-path setting: bf16
rolled table, 11/11/10-bit packed fracs and bf16 features, against the JAX
package's ``sorted_encode`` (Pallas kernels in interpret mode) at B = 700,
B = 1500 and for 700 identical points.

Tolerances, with their reasons: packed payloads round features to bf16 in
both, and a different f32 rounding before that can flip one bf16 ulp
(rtol 2^-7); table gradients vs JAX's Pallas backward: atol 3e-4, its
two-pass bf16 payload split (JAX ``bucket_matmul.py:160-169``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu.ops import span_gather as jsg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as JSpec,
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
def test_sorted_encode_packed_features_and_table_grads(case):
    """The main-path configuration: bf16 rolled table, packed payloads."""
    x = _points(case)
    B = x.shape[0]
    ct = np.random.default_rng(8).normal(size=(B, JS.output_dim)).astype(np.float32)
    jfeat, jgrad = _jax_fwd_and_grad(
        lambda xx, t: jsg.sorted_encode(xx, t, JS, jnp.bfloat16, True), x, ct)
    tt = torch.as_tensor(TABLE).requires_grad_(True)
    tfeat = tsg.sorted_encode(torch.as_tensor(x), tt, TS, torch.bfloat16, True)
    (tfeat * torch.as_tensor(ct)).sum().backward()
    assert tfeat.shape == (B, JS.output_dim)
    np.testing.assert_allclose(tfeat.detach().numpy(), jfeat, rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), jgrad, atol=3e-4)
