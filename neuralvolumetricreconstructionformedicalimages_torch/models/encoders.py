"""Point encoders: multiresolution hash grid, NeRF frequency bands, identity.

Port of the JAX ``models/encoders.py``: immutable specs with
``init(generator, device) -> params`` and ``apply(params, x, bound) ->
features``; the parameters themselves live in the ``nn.Module`` of the
field (``models/density_field.py``).

The hash path dispatches exactly like the JAX package (see
:meth:`HashEncoderSpec.apply`): positions in [-bound, bound] map to [0, 1]
and are clamped; every combination of the knobs has a path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.coherent_hash import (
    build_rolled_table,
    coherent_encode,
    coherent_encode_prebuilt,
    coherent_encode_reference,
    coherent_encode_takevjp,
)
from ..ops.hash_encoding import HashGridSpec, hash_encode, hash_encode_fast
from ..ops.span_gather import sorted_encode
from ..utils.profiling import layer_range

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class EncoderSpec:
    """Interface: output_dim, init(generator, device) -> params,
    apply(params, x, bound)."""

    output_dim: int

    def init(self, generator=None, device="cpu"):  # pragma: no cover
        raise NotImplementedError

    def apply(self, params, x, bound: float):  # pragma: no cover
        raise NotImplementedError

    def freeze(self, params):
        """Eval-time param preprocessing (default: no-op)."""
        return params


@dataclasses.dataclass(frozen=True)
class HashEncoderSpec(EncoderSpec):
    """Hash-grid encoder (same knobs as the JAX spec).

    - ``hash_variant``: "coherent" (linear hash, the fast paths) or "xor"
      (the reference's XOR-prime hash, bit-exact parity mode).
    - ``fast``: the kernel paths; ``False`` is the plain oracle.
    - ``forward``: "sorted" (span-gather kernel, no position gradients) or
      "rolled" (rolled-table wide-row gather).
    - ``backward``: "bucket" (sort + bucket kernel) or "take" (autograd
      through the rolled gather, no kernel).
    - ``table_dtype``: dtype of the rolled gather table.
    - ``pack_sort``: 11/11/10-bit fracs and bf16 feature pairs (sorted).
    - ``input_grads``: route the coherent fast path through the rolled
      forward, the fast path that gives position gradients.
    """

    grid: HashGridSpec = HashGridSpec()
    hash_variant: str = "coherent"
    fast: bool = True
    forward: str = "sorted"
    backward: str = "bucket"
    table_dtype: str = "float32"
    pack_sort: bool = True
    input_grads: bool = False

    def __post_init__(self):
        if self.backward not in ("bucket", "take"):
            raise ValueError(
                f"backward must be 'bucket' or 'take', got {self.backward!r}")
        if self.forward not in ("sorted", "rolled"):
            raise ValueError(
                f"forward must be 'sorted' or 'rolled', got {self.forward!r}")
        if self.table_dtype not in _DTYPES:
            raise ValueError(
                f"table_dtype must be 'float32' or 'bfloat16', "
                f"got {self.table_dtype!r}")

    @property
    def output_dim(self) -> int:
        return self.grid.output_dim

    @property
    def _table_dtype(self) -> torch.dtype:
        return _DTYPES[self.table_dtype]

    def init(self, generator: Optional[torch.Generator] = None, device="cpu",
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
        return {"table": self.grid.init(generator, device=device, dtype=dtype)}

    def freeze(self, params):
        """Eval-time params: prebuild the rolled gather table ONCE, so the
        tiled eval loops do not rebuild it per tile.  Only valid while the
        canonical table is frozen (no gradients flow)."""
        if self.hash_variant == "coherent" and self.fast:
            with torch.no_grad():
                rolled = build_rolled_table(
                    params["table"], self.grid, self._table_dtype)
            return dict(params, rolled=rolled)
        return params

    def apply(self, params, x: torch.Tensor, bound: float) -> torch.Tensor:
        """Encode world positions [..., D] -> [..., L*C].

        Paths, in the JAX package's order:

        1. XOR: ``hash_encode_fast`` (bucket kernel at D=0) when ``fast``,
           ``backward != "take"`` and the table size is a multiple of
           2048; else the plain ``hash_encode``.
        2. Coherent with frozen params (``freeze``): the prebuilt table.
        3. ``fast`` + ``take``: ``coherent_encode_takevjp``, any size.
        4. ``fast`` + ``forward: sorted`` without ``input_grads``, size a
           multiple of 2048: ``sorted_encode`` (the main path).
        5. ``fast``, size a multiple of 2048: ``coherent_encode``.
        6. Otherwise the oracle ``coherent_encode_reference``.

        Layer ranges: the scaling to the unit cube closes ``sample``; path 4
        runs its own, ``encode.index`` to ``encode.permute``, path 1 its own,
        ``encode.index`` and ``encode.gather``, every other path one
        ``encode``.
        """
        with layer_range("sample"):
            x01 = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)
        prefix = x01.shape[:-1]
        table = params.get("table")
        tiles = self.grid.table_size % 2048 == 0
        coherent = self.hash_variant == "coherent"
        if (coherent and "rolled" not in params and self.fast and self.backward != "take"
                and self.forward == "sorted" and not self.input_grads and tiles):
            # its own ranges, encode.index to encode.permute
            return sorted_encode(x01, table, self.grid, self._table_dtype, self.pack_sort)
        if self.hash_variant == "xor":
            # its own ranges, encode.index and encode.gather
            if self.fast and self.backward != "take" and tiles:
                return hash_encode_fast(x01, table, self.grid)
            return hash_encode(x01, table, self.grid)
        with layer_range("encode"):
            x01 = x01.reshape(-1, self.grid.input_dim)
            if coherent:
                if "rolled" in params:  # frozen eval params (see ``freeze``)
                    out = coherent_encode_prebuilt(x01, params["rolled"], self.grid)
                elif self.fast and self.backward == "take":
                    out = coherent_encode_takevjp(x01, table, self.grid,
                                                  self._table_dtype)
                elif self.fast and tiles:
                    out = coherent_encode(x01, table, self.grid, self._table_dtype)
                else:
                    out = coherent_encode_reference(x01, table, self.grid)
            else:
                raise NotImplementedError(
                    f"Unknown hash_variant {self.hash_variant!r}")
            return out.reshape(*prefix, self.output_dim)


@dataclasses.dataclass(frozen=True)
class FreqEncoderSpec(EncoderSpec):
    """NeRF-style sin/cos positional encoding."""

    input_dim: int = 3
    max_freq_log2: float = 5.0
    n_freqs: int = 6
    log_sampling: bool = True
    include_input: bool = True

    @property
    def freq_bands(self) -> np.ndarray:
        if self.log_sampling:
            return np.exp2(
                np.linspace(0.0, self.max_freq_log2, self.n_freqs)
            ).astype(np.float32)
        return np.linspace(1.0, 2.0 ** self.max_freq_log2,
                           self.n_freqs).astype(np.float32)

    @property
    def output_dim(self) -> int:
        d = self.input_dim * self.n_freqs * 2
        if self.include_input:
            d += self.input_dim
        return d

    def init(self, generator=None, device="cpu"):
        return {}

    def apply(self, params, x, bound: float):
        del params, bound  # stateless
        with layer_range("encode"):
            outs = [x] if self.include_input else []
            for freq in self.freq_bands:
                outs.append(torch.sin(x * float(freq)))
                outs.append(torch.cos(x * float(freq)))
            return torch.cat(outs, dim=-1)


@dataclasses.dataclass(frozen=True)
class IdentityEncoderSpec(EncoderSpec):
    """Pass-through encoder (``encoding: "None"``)."""

    input_dim: int = 3

    @property
    def output_dim(self) -> int:
        return self.input_dim

    def init(self, generator=None, device="cpu"):
        return {}

    def apply(self, params, x, bound: float):
        del params, bound
        return x


def get_encoder(
    encoding: str,
    input_dim: int = 3,
    multires: int = 6,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    hash_variant: str = "coherent",
    fast: bool = True,
    forward: str = "sorted",
    backward: str = "bucket",
    table_dtype: str = "float32",
    pack_sort: bool = True,
    input_grads: bool = False,
    **kwargs,
) -> EncoderSpec:
    """Encoder factory (``encoding`` one of hashgrid / frequency / None)."""
    if encoding == "None":
        return IdentityEncoderSpec(input_dim=input_dim)
    if encoding == "frequency":
        return FreqEncoderSpec(
            input_dim=input_dim, max_freq_log2=multires - 1, n_freqs=multires)
    if encoding == "hashgrid":
        return HashEncoderSpec(
            grid=HashGridSpec(
                input_dim=input_dim,
                num_levels=num_levels,
                level_dim=level_dim,
                base_resolution=base_resolution,
                log2_hashmap_size=log2_hashmap_size,
            ),
            hash_variant=hash_variant,
            fast=fast,
            forward=forward,
            backward=backward,
            table_dtype=table_dtype,
            pack_sort=pack_sort,
            input_grads=input_grads,
        )
    raise NotImplementedError(f"Unknown encoding {encoding!r}")
