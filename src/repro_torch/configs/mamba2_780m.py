"""Mamba2-780M — attention-free SSD (state-space duality) [arXiv:2405.21060]."""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,                # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, num_groups=1),
    tie_embeddings=True,
)
