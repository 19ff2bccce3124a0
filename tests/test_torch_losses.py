"""Port parity of the single-loss calculators of ``losses.py`` against the
JAX package on the same inputs (made from a seed with numpy), on the CPU.

Each calculator updates a ``loss`` dict; every key it writes is held
against JAX's at rtol 1e-6 (f32 means and sums in another order), the
Fourier terms at rtol 1e-5 (FFTs of another library).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neuralvolumetricreconstructionformedicalimages_tpu import losses as jl  # noqa: E402
from neuralvolumetricreconstructionformedicalimages_torch import losses as tl  # noqa: E402


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    c = lambda *s: (rng.normal(size=s) + 1j * rng.normal(size=s)).astype(np.complex64)  # noqa: E731
    return {
        "x": f(12, 10), "y": f(12, 10), "mask": (rng.random((12, 10)) > 0.4).astype(np.float32),
        "cx": c(12, 10), "cy": c(12, 10), "vol": f(6, 5, 4), "dens": f(32, 24),
        "vals": f(32, 24, 2), "data0": np.where(rng.random((12, 10)) > 0.5, 0.0,
                                                  f(12, 10)).astype(np.float32),
        "tv": np.float32(0.125), "batch": f(3, 8, 6), "row": f(1, 10),
    }


# name -> (calculator, arguments by input key, keyword arguments, rtol)
CASES = {
    "mse": ("calc_mse_loss", ["x", "y"], {}, 1e-6),
    "mse_tv": ("calc_mse_loss", ["x", "y", "tv"], {}, 1e-6),
    "mse_mask": ("calc_mse_loss_mask", ["x", "y", "mask"], {}, 1e-6),
    "mse_mask_none": ("calc_mse_loss_mask", ["x", "y"], {}, 1e-6),
    "phase_only": ("calc_phase_only_loss", ["cx", "cy"], {}, 1e-6),
    "hinge": ("calc_hinge_loss", ["x", "y"], {}, 1e-6),
    "mse_gradient": ("calc_mse_loss_with_gradient", ["x", "y"], {"lambda_grad": 0.3}, 1e-6),
    "mse_gradient_mask": ("calc_mse_loss_with_gradient", ["x", "y", "mask"], {}, 1e-6),
    "huber": ("calc_huber_loss", ["x", "y"], {"delta": 0.7}, 1e-6),
    "zero": ("calc_zero_loss", ["x", "data0"], {"weight": 2.0}, 1e-6),
    "small": ("calc_small_loss", ["x"], {"weight": 0.5}, 1e-6),
    "tv_3d": ("calc_tv_loss_3d", ["vol"], {"k": 0.2}, 1e-6),
    "tv_2d": ("calc_tv_loss", ["batch"], {"weight": 0.3}, 1e-6),
    "tv_regularization": ("compute_tv_regularization", ["vals"], {"weight": 0.01}, 1e-6),
    "fourier": ("calc_fourier_loss", ["x", "y"], {}, 1e-5),
    "fourier_batch": ("calc_fourier_loss", ["batch", "batch"], {"lambda_sparsity": 0.1}, 1e-5),
    "fourier_one_row": ("calc_fourier_loss", ["row", "row"], {}, 1e-5),
    "fourier_sparsity": ("calc_fourier_sparsity_loss", ["batch"], {"weight": 0.4}, 1e-5),
    "l1": ("calc_l1_loss", ["x", "y"], {}, 1e-6),
}


@pytest.mark.parametrize("start", [{}, {"loss": 0.25}], ids=["empty", "running"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_calculator_matches_jax(case, start):
    name, keys, kw, rtol = CASES[case]
    inp = _inputs()
    jout = getattr(jl, name)(dict(start), *[jnp.asarray(inp[k]) for k in keys], **kw)
    tout = getattr(tl, name)(dict(start), *[torch.as_tensor(inp[k]) for k in keys], **kw)
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(np.asarray(tout[k]), np.asarray(jout[k]), rtol=rtol,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("fn", ["masked_mse", "total_variation_loss"])
def test_reductions_match_jax(fn):
    inp = _inputs()
    if fn == "masked_mse":
        for args in (("x", "y"), ("x", "y", "mask")):
            np.testing.assert_allclose(
                tl.masked_mse(*[torch.as_tensor(inp[k]) for k in args]).numpy(),
                np.asarray(jl.masked_mse(*[jnp.asarray(inp[k]) for k in args])), rtol=1e-6)
        empty = torch.zeros((12, 10))
        assert float(tl.masked_mse(torch.as_tensor(inp["x"]), torch.as_tensor(inp["y"]),
                                   empty)) == 0.0
    else:
        np.testing.assert_allclose(
            tl.total_variation_loss(torch.as_tensor(inp["dens"])).numpy(),
            np.asarray(jl.total_variation_loss(jnp.asarray(inp["dens"]))), rtol=1e-6)


@pytest.mark.parametrize("fn", ["fourier_transform", "inverse_fourier_transform"])
def test_fourier_transforms_match_jax(fn):
    x = _inputs()["cx"]
    got = getattr(tl, fn)(torch.as_tensor(x)).numpy()
    want = np.asarray(getattr(jl, fn)(jnp.asarray(x)))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_calculator_input_checks():
    with pytest.raises(ValueError, match="3D"):
        tl.calc_tv_loss_3d({}, torch.zeros((4, 4)), 1.0)
    with pytest.raises(ValueError, match="at least 2"):
        tl.calc_fourier_loss({}, torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError, match="at least 2"):
        tl.calc_fourier_sparsity_loss({}, torch.zeros(4), 1.0)
