"""Port parity: hash-grid spec, coherent-hash index math, the plain encoder
oracle and eval path, payload packing, config loading -- each against the
JAX package on the same numpy inputs -- and the port's isolation from JAX.

Tolerances: integer results (base indices, offsets, packed payloads) must
be bit-exact; float results are float32 computations of the same formula
in both frameworks, so they agree to a few float32 ulps (atol 1e-6 on
O(1) values) unless a test says otherwise.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu import config as jcfg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops import coherent_hash as jch  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops import span_gather as jsg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_tpu.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as JSpec,
)
from neuralvolumetricreconstructionformedicalimages_torch import config as tcfg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import coherent_hash as tch  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops import span_gather as tsg  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch.ops.hash_encoding import (  # noqa: E402
    HashGridSpec as TSpec,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "neuralvolumetricreconstructionformedicalimages_torch"

# dense levels (res 4, 8, 16) and hashed levels (res 32, 64) in one spec
SMALL = dict(num_levels=5, base_resolution=4, log2_hashmap_size=14)
FULL = dict()  # the main path: 16 levels x 2^19 x 2


def _points(seed, n, d=3):
    return np.random.default_rng(seed).uniform(0, 1, (n, d)).astype(np.float32)


@pytest.mark.parametrize("kw", [SMALL, FULL], ids=["small", "full"])
def test_spec_and_offsets_match(kw):
    js, ts = JSpec(**kw), TSpec(**kw)
    for name in ("scales", "resolutions", "level_sizes", "dense_levels"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    assert ts.n_params == js.n_params and ts.output_dim == js.output_dim
    np.testing.assert_array_equal(tch.multipliers(ts), jch.multipliers(js))
    np.testing.assert_array_equal(tch.corner_offsets(ts), jch.corner_offsets(js))


def test_table_init_range():
    t = TSpec(**SMALL).init(torch.Generator().manual_seed(0))
    assert t.shape == (5, 1 << 14, 2) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 3e-5


@pytest.mark.parametrize("kw", [SMALL, FULL], ids=["small", "full"])
def test_base_indices_bit_exact(kw):
    """Base indices equal JAX's int32-wraparound ones bit for bit."""
    js, ts = JSpec(**kw), TSpec(**kw)
    x = _points(1, 4096)
    jb, jf = jch.base_and_frac(js, jnp.asarray(x))
    tb, tf = tch.base_and_frac(ts, torch.as_tensor(x))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    jbt, jft = jch.base_and_frac_t(js, jnp.asarray(x))
    tbt, tft = tch.base_and_frac_t(ts, torch.as_tensor(x))
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
    np.testing.assert_allclose(tft.numpy(), np.asarray(jft), atol=1e-6)
    assert tbt.dtype == torch.int32


def test_corner_weights_match():
    js, ts = JSpec(**SMALL), TSpec(**SMALL)
    f = _points(2, 300 * 5).reshape(300, 5, 3)
    np.testing.assert_allclose(
        tch.corner_weights(ts, torch.as_tensor(f)).numpy(),
        np.asarray(jch.corner_weights(js, jnp.asarray(f))), atol=1e-7)


def test_reference_encoder_features_and_table_grads():
    """The autograd oracle: features and table gradients vs JAX's oracle
    (sums of 8 products of N(0,1) values: atol 1e-5)."""
    js, ts = JSpec(**SMALL), TSpec(**SMALL)
    rng = np.random.default_rng(3)
    x = _points(3, 777)
    table = rng.normal(size=(5, 1 << 14, 2)).astype(np.float32)
    ct = rng.normal(size=(777, js.output_dim)).astype(np.float32)
    jout, jgrad = jax.value_and_grad(
        lambda t: jnp.vdot(jch.coherent_encode_reference(jnp.asarray(x), t, js),
                           jnp.asarray(ct)))(jnp.asarray(table))
    tt = torch.as_tensor(table).requires_grad_(True)
    tout = tch.coherent_encode_reference(torch.as_tensor(x), tt, ts)
    (tout * torch.as_tensor(ct)).sum().backward()
    jfeat = jch.coherent_encode_reference(jnp.asarray(x), jnp.asarray(table), js)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jfeat), atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_rolled_table_and_prebuilt_encode(dtype):
    """Eval path: build_rolled_table is a copy (bit-exact); the prebuilt
    encode interpolates it (f32 sums of 8 terms: atol 1e-5)."""
    js, ts = JSpec(**SMALL), TSpec(**SMALL)
    rng = np.random.default_rng(4)
    table = rng.normal(size=(5, 1 << 14, 2)).astype(np.float32)
    x = _points(4, 999)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jr = jch.build_rolled_table(jnp.asarray(table), js, jd)
    tr = tch.build_rolled_table(torch.as_tensor(table), ts, td)
    np.testing.assert_array_equal(tr.float().numpy(),
                                  np.asarray(jr).astype(np.float32))
    jo = jch.coherent_encode_prebuilt(jnp.asarray(x), jr, js)
    to = tch.coherent_encode_prebuilt(torch.as_tensor(x), tr, ts)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)


def test_frac_packing_bit_exact():
    f = np.random.default_rng(5).uniform(0, 1, (4, 3, 1000)).astype(np.float32)
    f[0, :, :3] = [[0.0, 1.0, 0.99999994]] * 3  # edges of the range
    jp = np.array(jsg.pack_frac_t(jnp.asarray(f)))
    tp = tsg.pack_frac_t(torch.as_tensor(f))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tsg.unpack_frac_t(tp).numpy(),
                                  np.asarray(jsg.unpack_frac_t(jnp.asarray(jp))))
    fl = np.moveaxis(f, 1, -1)
    np.testing.assert_array_equal(tsg.pack_frac(torch.as_tensor(fl)).numpy(),
                                  np.asarray(jsg.pack_frac(jnp.asarray(fl))))
    np.testing.assert_array_equal(
        tsg.unpack_frac(torch.as_tensor(jp)).numpy(),
        np.asarray(jsg.unpack_frac(jnp.asarray(jp))))


def test_feature_packing_bit_exact():
    fs = np.random.default_rng(6).normal(size=(5, 2, 333)).astype(np.float32)
    jp = np.array(jsg._pack_feats(jnp.asarray(fs)))
    tp = tsg._pack_feats(torch.as_tensor(fs))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(
        tsg._unpack_feats(tp.t()).numpy(),
        np.asarray(jsg._unpack_feats(jnp.asarray(jp).T)))


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(REPO, "configs")) if f.endswith(".yaml")))
def test_config_loading_matches(name, monkeypatch):
    monkeypatch.chdir(REPO)
    path = os.path.join("configs", name)
    assert tcfg.with_defaults(tcfg.load_config(path))["train"] == \
        jcfg.with_defaults(jcfg.load_config(path))["train"]
    assert tcfg.load_config(path) == jcfg.load_config(path)


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX and the JAX package
    out of sys.modules (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PKG} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k.startswith('neuralvolumetricreconstructionformedicalimages_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith(p.__name__)]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_sources_name_no_jax():
    """No source file of the port (nor chip_smoke.py) has an import of jax
    or of the JAX package."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|optax|"
                     r"neuralvolumetricreconstructionformedicalimages_tpu)\b",
                     re.MULTILINE)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, PKG)):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            assert not bad.search(fh.read()), path
