"""Whisper-large-v3 — audio encoder-decoder [arXiv:2212.04356].

Backbone only: the conv frontend is a STUB — ``input_specs`` provides
precomputed frame embeddings [B, 1500, d_model] as the encoder input.
Decoder: causal self-attention (KV cache) + cross-attention over the encoder
memory (cross-KV computed once at prefill).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,               # decoder
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    cross_attention=True,
    frontend="audio_frames",
    frontend_seq=1500,
)
