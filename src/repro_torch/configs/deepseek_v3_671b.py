"""DeepSeek-V3-671B — MLA + MoE (1 shared + 256 routed, top-8)
[arXiv:2412.19437].

MLA (multi-head latent attention) compresses the KV cache to
``kv_lora_rank + qk_rope_dim`` floats/token; decode uses the absorbed-weight
formulation.  First 3 layers are dense FFN (d_ff 18432); the remaining 58 are
MoE with expert d_ff 2048.  MTP (multi-token prediction) is exposed as an
optional training head (see models/transformer.py mtp support note).
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,                 # dense layers (first_k_dense)
    vocab_size=129280,
    head_dim=128,
    moe=MoEConfig(
        num_experts=256,
        experts_per_token=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        first_k_dense=3,
        layer_period=1,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    rope_theta=10_000.0,
)
