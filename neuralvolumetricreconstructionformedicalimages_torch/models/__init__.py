from .density_field import DensityField, get_network, params_from_jax
from .encoders import (
    EncoderSpec,
    FreqEncoderSpec,
    HashEncoderSpec,
    IdentityEncoderSpec,
    get_encoder,
)

__all__ = [
    "DensityField", "get_network", "params_from_jax", "EncoderSpec",
    "FreqEncoderSpec", "HashEncoderSpec", "IdentityEncoderSpec", "get_encoder",
]
