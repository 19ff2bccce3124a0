"""Port parity of the span gather's table mode, which reads the canonical
[L, S, C] table at the corners' offsets instead of the feature-major
rolled copy, and of the main path that now runs it.

On the CPU the wrappers run their plain versions, so these tests hold the
table mode's plain version, and ``sorted_encode`` (the point-order mode's
plain version gathers through it), against the JAX package (its Pallas roll and span gather in interpret
mode, as the JAX tests run them; ``log2_hashmap_size=14`` takes those
paths) and against the rolled mode's plain version.  The kernel's two
modes are held against each other on the card in ``test_torch_cuda.py``.

Tolerances, with their reasons:

- table mode vs JAX's span gather on JAX's rolled table: both read the
  same (rounded) values and sum the same f32 products in the same k
  order; the Pallas kernel selects rows by exact one-hot products, so
  atol 1e-5, the existing span tolerance (``test_torch_kernels.py``);
- table mode vs the rolled mode's plain version: the same values through
  the same arithmetic, so bit-equal (``torch.equal``);
- ``sorted_encode`` vs JAX's: as ``test_torch_encode.py`` and
  ``test_torch_encode_packed.py`` state them (features atol 1e-5, or
  rtol 2^-7 where both round features to bf16; table gradients atol 3e-4,
  the Pallas backward's two-pass bf16 payload split).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu.ops import roll_kernels as jrk  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops import span_gather as jsg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as JSpec,
)
from neuralvolumetricreconstructionformedicalimages_torch.ops import roll_kernels as trk  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as tsg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops.coherent_hash import (  # noqa: E402
    base_and_frac_t,
)
from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as TSpec,
)

L, S, C = 5, 1 << 14, 2
B = 2048  # the Pallas span gather takes streams of whole 1024-point chunks


def _specs(D):
    kw = dict(num_levels=L, base_resolution=4, log2_hashmap_size=14, input_dim=D)
    return JSpec(**kw), TSpec(**kw)


def _table(seed):
    return np.random.default_rng(seed).normal(size=(L, S, C)).astype(np.float32)


def _stream(seed, D):
    """Sorted keys [L, B] whose last 16 fall in the table's last 8 columns
    (their corners wrap past S), and fracs [L, D, B]."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, S, (L, B))
    keys[:, -16:] = rng.integers(S - 8, S, (L, 16))
    keys = np.sort(keys, axis=1).astype(np.int32)
    frac = rng.uniform(0, 1, (L, D, B)).astype(np.float32)
    return keys, frac


def _fracs(frac, packed):
    """(JAX, torch) fracs: f32 [L, D, B] or packed int32 [L, 1, B]."""
    if packed:
        jf = jsg.pack_frac_t(jnp.asarray(frac))[:, None, :]
        return jf, torch.as_tensor(np.array(jf))
    return jnp.asarray(frac), torch.as_tensor(frac)


CASES = [("float32", False, 3), ("bfloat16", True, 3), ("bfloat16", False, 3),
         ("float32", False, 1), ("float32", False, 2)]
IDS = ["f32_unpacked_d3", "bf16_packed_d3", "bf16_unpacked_d3",
       "f32_unpacked_d1", "f32_unpacked_d2"]


@pytest.mark.parametrize("dtype,packed,D", CASES, ids=IDS)
def test_table_mode_matches_jax_span_gather(dtype, packed, D):
    """Table mode on the canonical table vs JAX's span gather on JAX's
    rolled table (atol 1e-5)."""
    js, ts = _specs(D)
    keys, frac = _stream(20 + D, D)
    table = _table(21)
    jR = jax.jit(lambda a: jrk.roll_broadcast_fm(a, js, getattr(jnp, dtype)))(
        jnp.asarray(table))
    jf, tf = _fracs(frac, packed)
    j = jax.jit(lambda k, f, r: jsg.span_gather_sorted(k, f, r, input_dim=D))(
        jnp.asarray(keys), jf, jR)
    t = tsg.span_gather_sorted_table_plain(torch.as_tensor(keys), tf,
                                           torch.as_tensor(table), ts,
                                           getattr(torch, dtype))
    assert t.shape == (L, C, B) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32), atol=1e-5)
    # the wrapper runs the same plain version for CPU tensors
    w = tsg.span_gather_sorted_table(torch.as_tensor(keys), tf,
                                     torch.as_tensor(table), ts,
                                     getattr(torch, dtype))
    assert torch.equal(w, t)


@pytest.mark.parametrize("offsets", ["spec", "last_column"])
@pytest.mark.parametrize("dtype,packed,D", CASES[:2] + CASES[3:], ids=[
    IDS[0], IDS[1], IDS[3], IDS[4]])
def test_table_mode_equals_rolled_mode(monkeypatch, dtype, packed, D, offsets):
    """Table mode == rolled mode's plain version on the plain roll, bit for
    bit, with keys in the last 8 columns; with ``last_column`` every
    corner but the first sits S - 1 columns past its key, so nearly every
    corner row wraps."""
    _, ts = _specs(D)
    if offsets == "last_column":
        K = 1 << D
        offs = np.full((L, K), S - 1, np.int32)
        offs[:, 0] = 0
        offs[:, -1] = S - 8
        monkeypatch.setattr(tsg, "corner_offsets", lambda spec: offs)
        monkeypatch.setattr(trk, "corner_offsets", lambda spec: offs)
    keys, frac = _stream(30 + D, D)
    _, tf = _fracs(frac, packed)
    table = torch.as_tensor(_table(31))
    tdt = getattr(torch, dtype)
    t = tsg.span_gather_sorted_table_plain(torch.as_tensor(keys), tf, table, ts, tdt)
    r = tsg.span_gather_sorted_plain(
        torch.as_tensor(keys), tf, trk.roll_broadcast_fm_plain(table, ts, tdt),
        input_dim=D)
    assert torch.equal(t, r)


# dense levels (res 8, 16) and a hashed one (res 32), as test_torch_encode.py
KW = dict(num_levels=3, base_resolution=8, log2_hashmap_size=14)
JS3, TS3 = JSpec(**KW), TSpec(**KW)
TABLE3 = np.random.default_rng(7).normal(size=(3, 1 << 14, 2)).astype(np.float32)


@pytest.mark.parametrize("dtype,pack", [("float32", False), ("bfloat16", True),
                                        ("bfloat16", False)],
                         ids=["f32", "bf16_packed", "bf16_unpacked"])
def test_sorted_encode_table_route_matches_jax(dtype, pack):
    """The main path (sort, table-mode gather, un-permute; bucket + unroll
    backward) vs JAX's sorted_encode (roll + Pallas span gather)."""
    x = np.random.default_rng(40).uniform(0, 1, (1200, 3)).astype(np.float32)
    ct = np.random.default_rng(41).normal(size=(1200, JS3.output_dim)).astype(np.float32)

    def both(tb):
        out, vjp = jax.vjp(lambda t: jsg.sorted_encode(
            jnp.asarray(x), t, JS3, getattr(jnp, dtype), pack), tb)
        return out, vjp(jnp.asarray(ct))[0]

    jfeat, jgrad = (np.asarray(a, np.float32)
                    for a in jax.jit(both)(jnp.asarray(TABLE3)))
    tt = torch.as_tensor(TABLE3).requires_grad_(True)
    tfeat = tsg.sorted_encode(torch.as_tensor(x), tt, TS3, getattr(torch, dtype), pack)
    (tfeat * torch.as_tensor(ct)).sum().backward()
    assert tfeat.shape == (1200, JS3.output_dim)
    if pack:
        np.testing.assert_allclose(tfeat.detach().numpy(), jfeat,
                                   rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(tfeat.detach().numpy(), jfeat, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), jgrad, atol=3e-4)


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
def test_sorted_encode_routes_table_mode(monkeypatch, pack):
    """``sorted_encode`` builds no rolled table and gathers from the
    canonical table: in the point-order mode with packed positions (the
    card's sequence, here through its plain version), in the table mode
    with f32 positions; ``sorted_encode_features`` keeps the rolled route;
    all give the same features."""
    calls = []

    def no_roll(*a, **k):
        raise AssertionError("the main path built the rolled table")

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(trk, "roll_broadcast_fm", no_roll)
    monkeypatch.setattr(tsg, "span_gather_sorted_table",
                        spy("table", tsg.span_gather_sorted_table))
    monkeypatch.setattr(tsg, "span_gather_point_order",
                        spy("point_order", tsg.span_gather_point_order))
    monkeypatch.setattr(tsg, "span_gather_sorted",
                        spy("rolled", tsg.span_gather_sorted))
    x = torch.as_tensor(np.random.default_rng(42).uniform(0, 1, (900, 3)),
                        dtype=torch.float32)
    table = torch.as_tensor(TABLE3)
    out = tsg.sorted_encode(x, table, TS3, torch.bfloat16, pack)
    mode = "point_order" if pack else "table"
    assert calls == [mode]
    base_t, frac_t = base_and_frac_t(TS3, x)
    rolled = trk.roll_broadcast_fm_plain(table, TS3, torch.bfloat16)
    feats = tsg.sorted_encode_features(base_t, frac_t, rolled, 3, pack=pack)
    assert calls == [mode, "rolled"]
    assert torch.equal(out, feats)
