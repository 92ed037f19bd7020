"""Models: parameter descriptors, shared layers, the Mamba-2 block and the decoder."""

from repro_torch.models.model import DecoderLM, build_model
from repro_torch.models.params import init_params, params_from_jax

__all__ = ["DecoderLM", "build_model", "init_params", "params_from_jax"]
