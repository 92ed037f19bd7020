"""Models: parameter descriptors, shared layers and the dense decoder."""

from repro_torch.models.model import DecoderLM, build_model
from repro_torch.models.params import init_params, params_from_jax

__all__ = ["DecoderLM", "build_model", "init_params", "params_from_jax"]
