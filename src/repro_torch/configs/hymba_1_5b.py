"""Hymba-1.5B — hybrid: parallel attention + mamba heads in every layer
[arXiv:2411.13676].

Sliding-window attention (1024) on all layers makes the hybrid sub-quadratic,
which is what qualifies it for the long_500k shape (the SSM branch carries
global context; the attention branch is local — the Hymba design point).
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    parallel_ssm=True,
    attn_window=1024,
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, num_groups=1),
)
