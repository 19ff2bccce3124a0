"""Density field: encoder + skip-connection MLP over attenuation.

Port of the JAX ``models/density_field.py`` as an ``nn.Module``:

- ``num_layers`` linear layers, LeakyReLU(0.01) between them;
- the *encoded input* is re-concatenated before each layer listed in
  ``skips``, as ``[input_pts, h]``;
- final activation sigmoid / (leaky)relu / tanh / none;
- init U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases (the
  ``torch.nn.Linear`` default distribution), drawn from an explicit
  generator.

The hash table is the parameter ``table`` ([L, S, C]); the layers are
``layers.<i>`` ``nn.Linear``s.  :func:`params_from_jax` carries a JAX
parameter tree across (JAX weights are ``[fan_in, fan_out]``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from ..utils.profiling import layer_range, mark_on_grad
from .encoders import EncoderSpec

_LEAKY_SLOPE = 0.01  # torch.nn.LeakyReLU default


def _last_activation(name: str):
    if name == "sigmoid":
        return torch.sigmoid
    if name == "relu":  # the reference maps "relu" to LeakyReLU
        return lambda x: Fn.leaky_relu(x, _LEAKY_SLOPE)
    if name == "tanh":
        return torch.tanh
    if name == "none":
        return lambda x: x
    raise NotImplementedError(f"Unknown last activation {name!r}")


class DensityField(nn.Module):
    """Encoder + MLP field: world positions [..., D] -> [..., out_dim]."""

    def __init__(self, encoder: EncoderSpec, bound: float = 0.2,
                 num_layers: int = 8, hidden_dim: int = 256,
                 skips: Sequence[int] = (4,), out_dim: int = 1,
                 last_activation: str = "sigmoid",
                 compute_dtype: str = "float32", *,
                 generator: Optional[torch.Generator] = None,
                 device="cpu"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                             f"got {compute_dtype!r}")
        self.encoder = encoder
        self.bound = float(bound)
        self.num_layers = int(num_layers)
        self.hidden_dim = int(hidden_dim)
        self.skips: Tuple[int, ...] = tuple(int(s) for s in skips)
        self.out_dim = int(out_dim)
        self.last_activation = last_activation
        self.compute_dtype = compute_dtype
        self._act = _last_activation(last_activation)

        enc = encoder.init(generator, device=device)
        self.table = nn.Parameter(enc["table"]) if "table" in enc else None
        layers = []
        with torch.no_grad():
            for fan_in, fan_out in self.layer_dims:
                lin = nn.Linear(fan_in, fan_out, device=device)
                b = 1.0 / math.sqrt(fan_in)
                lin.weight.uniform_(-b, b, generator=generator)
                lin.bias.uniform_(-b, b, generator=generator)
                layers.append(lin)
        self.layers = nn.ModuleList(layers)

    @property
    def layer_dims(self) -> Sequence[Tuple[int, int]]:
        """(fan_in, fan_out) per linear layer."""
        in_dim = self.encoder.output_dim
        dims = [(in_dim, self.hidden_dim)]
        for i in range(1, self.num_layers - 1):
            fan_in = self.hidden_dim + (in_dim if i in self.skips else 0)
            dims.append((fan_in, self.hidden_dim))
        dims.append((self.hidden_dim, self.out_dim))
        return dims

    def encoder_params(self) -> Dict[str, torch.Tensor]:
        return {} if self.table is None else {"table": self.table}

    def freeze(self) -> Dict[str, torch.Tensor]:
        """Eval-time encoder params (prebuilt rolled table, no gradients);
        pass them to ``forward(x, enc_params=...)``."""
        return self.encoder.freeze(
            {k: v.detach() for k, v in self.encoder_params().items()})

    def forward(self, x: torch.Tensor,
                enc_params: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        params = self.encoder_params() if enc_params is None else enc_params
        h = self.encoder.apply(params, x, self.bound)
        with layer_range("mlp"):
            input_pts = h
            bf16 = self.compute_dtype == "bfloat16"
            n = len(self.layers)
            for i, lin in enumerate(self.layers):
                if i in self.skips:
                    h = torch.cat([input_pts, h], dim=-1)
                if bf16:
                    # bf16 operands, f32 products and sums (the JAX
                    # preferred_element_type=float32 contraction)
                    h = Fn.linear(h.to(torch.bfloat16).float(),
                                  lin.weight.to(torch.bfloat16).float()) + lin.bias
                else:
                    h = Fn.linear(h, lin.weight, lin.bias)
                h = Fn.leaky_relu(h, _LEAKY_SLOPE) if i < n - 1 else self._act(h)
        # the backward through the MLP starts once the output's gradient is
        # complete, i.e. after the loss's and the renderer's
        mark_on_grad(h, "backward.mlp")
        return h


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> ``DensityField`` state_dict.

    ``{"encoder": {"table": [L, S, C]}, "layers": [{"w": [fan_in, fan_out],
    "b": [fan_out]}, ...]}``: weights are transposed for ``nn.Linear``, the
    table is kept as it is.
    """
    sd: Dict[str, torch.Tensor] = {}
    table = params.get("encoder", {}).get("table")
    if table is not None:
        sd["table"] = torch.as_tensor(np.array(table, np.float32))
    for i, layer in enumerate(params["layers"]):
        sd[f"layers.{i}.weight"] = torch.as_tensor(
            np.array(np.asarray(layer["w"], np.float32).T, order="C"))
        sd[f"layers.{i}.bias"] = torch.as_tensor(np.array(layer["b"], np.float32))
    return sd


def get_network(net_type: str):
    """Network factory (``net_type: mlp``)."""
    if net_type == "mlp":
        return DensityField
    raise NotImplementedError(f"Unknown network type {net_type!r}")
