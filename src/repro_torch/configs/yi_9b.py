"""Yi-9B — llama-arch dense GQA [arXiv:2403.04652]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5_000_000.0,
)
