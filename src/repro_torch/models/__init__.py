"""Models: parameter descriptors, shared layers, the Mamba-2 block, the decoder and the
encoder-decoder."""

from repro_torch.models.model import DecoderLM, EncDecLM, build_model
from repro_torch.models.params import init_params, params_from_jax

__all__ = ["DecoderLM", "EncDecLM", "build_model", "init_params", "params_from_jax"]
