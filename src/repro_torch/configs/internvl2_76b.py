"""InternVL2-76B — VLM [arXiv:2404.16821].

Backbone-only per the brief: the InternViT frontend is a STUB; ``input_specs``
provides precomputed patch embeddings (``frontend_seq`` positions of the token
sequence carry patch embeddings instead of token embeddings — early fusion).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    frontend="vision_patches",
    frontend_seq=256,
)
