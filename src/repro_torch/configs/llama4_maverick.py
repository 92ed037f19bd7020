"""Llama-4 Maverick 400B-A17B — MoE, 128 routed experts top-1 + shared,
alternating dense/MoE layers [hf:meta-llama/Llama-4 family].

Early fusion is a frontend property; per the brief's [moe] tag this config is
the text backbone (the VLM stub pattern is exercised by internvl2-76b).
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=16384,                 # dense (non-MoE) layers
    vocab_size=202048,
    head_dim=128,
    moe=MoEConfig(
        num_experts=128,
        experts_per_token=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        first_k_dense=0,
        layer_period=2,          # every other layer is MoE
    ),
    rope_theta=500_000.0,
)
