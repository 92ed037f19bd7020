"""Granite-3-8B — dense GQA [hf:ibm-granite/granite-3.0 family]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    head_dim=128,
    rope_theta=10_000_000.0,
)
