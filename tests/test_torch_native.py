"""The port's host data engine (C++ through ctypes): beam masks and
valid-pixel pools bit-equal to the NumPy paths and to the JAX package's
engine, and a build that two processes can run at once.
"""

import ctypes
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from neuralvolumetricreconstructionformedicalimages_tpu import native as jnative
from neuralvolumetricreconstructionformedicalimages_torch import native
from neuralvolumetricreconstructionformedicalimages_torch.metrics import get_ptycho_mask
from neuralvolumetricreconstructionformedicalimages_torch.native import build as nbuild

REPO = Path(__file__).resolve().parents[1]


def test_engine_builds_and_loads():
    assert native.available(), native.load_error()
    assert native.load_error() is None


def test_library_is_the_ports_own():
    """The port builds into the repository's build/ directory under a
    name with the source's hash, never the JAX package's library."""
    path = nbuild.lib_path()
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libnvr_data_engine-") and path.suffix == ".so"
    assert Path(native.build.build()) == path
    jax_src = REPO / "neuralvolumetricreconstructionformedicalimages_tpu" / "native"
    assert nbuild.SRC.parent.parent != jax_src
    assert "nvr_native_" not in str(path)


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("shape", [(1, 16, 16), (3, 64, 48), (2, 33, 129)])
def test_ptycho_mask_bit_equal(shape, kind):
    rng = np.random.default_rng(sum(shape))
    hr = rng.normal(size=shape) * 0.01
    if kind == "complex":
        hr = hr + 1j * rng.normal(size=shape) * 0.004
    got = native.ptycho_mask_batch(hr, 0.007)
    mag = np.abs(hr).astype(np.float32)
    want = np.stack([get_ptycho_mask(m, 0.007).astype(np.float32) for m in mag])
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native._ptycho_mask_batch_numpy(mag, 0.007))
    np.testing.assert_array_equal(got, jnative.ptycho_mask_batch(hr, 0.007))


def test_ptycho_mask_single_view():
    hr = np.random.default_rng(0).normal(size=(24, 20)) * 0.01
    np.testing.assert_array_equal(native.ptycho_mask_batch(hr),
                                  jnative.ptycho_mask_batch(hr))


@pytest.mark.parametrize("case", ["sparse", "all_invalid_view", "all_valid",
                                  "every_view_invalid"])
def test_build_pools_bit_equal(case):
    rng = np.random.default_rng(1)
    projs = rng.normal(size=(5, 24, 18)).astype(np.float32)
    if case != "all_valid":
        projs[np.abs(projs) < 0.8] = 0.0
    if case == "all_invalid_view":
        projs[1] = 0.0
    if case == "every_view_invalid":
        projs[:] = 0.0
    pools, counts = native.build_pools(projs)
    assert pools.dtype == np.int32 and counts.dtype == np.int32
    for other in (native._build_pools_numpy(projs), jnative.build_pools(projs),
                  jnative._build_pools_numpy(projs)):
        np.testing.assert_array_equal(counts, other[1])
        np.testing.assert_array_equal(pools, other[0])
    if case.endswith("invalid_view"):
        assert counts[1] == 24 * 18 and pools.shape[1] == 24 * 18


def test_concurrent_builds_into_one_directory(tmp_path):
    """Two processes build into one fresh directory at once; both load a
    whole library."""
    code = textwrap.dedent(f"""
        import ctypes, sys
        sys.path.insert(0, {str(REPO)!r})
        from neuralvolumetricreconstructionformedicalimages_torch.native.build import build
        lib = ctypes.CDLL(str(build({str(tmp_path)!r})))
        lib.nvr_version.restype = ctypes.c_int32
        assert lib.nvr_version() == 1
        print("loaded")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "loaded" in out
    libs = sorted(tmp_path.glob("*.so"))
    assert [lib.name for lib in libs] == [nbuild.lib_path(tmp_path).name]
    assert not list(tmp_path.glob("*.tmp"))
    lib = ctypes.CDLL(str(libs[0]))
    lib.nvr_version.restype = ctypes.c_int32
    assert lib.nvr_version() == 1
