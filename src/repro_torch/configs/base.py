"""Architecture + shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig`; every input shape
is a :class:`ShapeConfig`.  A (arch × shape) pair fully determines what the
launcher lowers: ``train_step`` for training shapes, ``prefill_step`` /
``decode_step`` for inference shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_k_dense: int = 0            # leading dense layers (deepseek: 3)
    layer_period: int = 1             # 1 = every layer MoE; 2 = alternating (llama4)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    router_z_weight: float = 0.0001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int                     # N
    head_dim: int = 64                 # P
    expand: int = 2                    # d_inner = expand * d_model
    num_groups: int = 1                # G (B/C groups)
    conv_kernel: int = 4
    chunk: int = 256

    def num_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (hymba): parallel attn + ssm heads within one layer
    parallel_ssm: bool = False
    attn_window: int | None = None     # sliding-window attention (None = full)
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub (vlm/audio): precomputed embeddings prepended
    frontend: str | None = None        # "vision_patches" | "audio_frames"
    frontend_seq: int = 0
    # numerics
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"                # "none" | "full" | "dots"

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(1, self.num_kv_heads):
            raise ValueError("num_heads must be divisible by num_kv_heads")

    # -- derived sizes ---------------------------------------------------------

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: attention-free, or windowed attention."""
        if self.family == "ssm":
            return True
        return self.attn_window is not None

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.mla is not None:
            m = self.mla
            q = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (
                m.qk_nope_dim + m.qk_rope_dim
            )
            kv = d * (m.kv_lora_rank + m.qk_rope_dim) + m.kv_lora_rank * self.num_heads * (
                m.qk_nope_dim + m.v_head_dim
            )
            o = self.num_heads * m.v_head_dim * d
            return q + kv + o
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def _ssm_params(self) -> int:
        if self.ssm is None:
            return 0
        s = self.ssm
        d = self.d_model
        d_in = s.d_inner(d)
        h = s.num_heads(d)
        proj_in = d * (2 * d_in + 2 * s.num_groups * s.state_dim + h)
        conv = (d_in + 2 * s.num_groups * s.state_dim) * s.conv_kernel
        return proj_in + conv + 2 * h + d_in + d_in * d   # +a_log,D,norm,out_proj

    def _ffn_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff                    # swiglu: gate, up, down

    def layer_params(self, layer_idx: int) -> int:
        """Parameter count of one decoder layer (norms excluded, negligible)."""
        p = 0
        if self.family == "ssm":
            return self._ssm_params()
        p += self._attn_params()
        if self.parallel_ssm:
            p += self._ssm_params()
        if self.moe is not None and self.is_moe_layer(layer_idx):
            m = self.moe
            p += (m.num_experts + m.num_shared_experts) * 3 * self.d_model * m.d_ff_expert
            p += self.d_model * m.num_experts             # router
        else:
            p += self._ffn_params(self.d_ff)
        return p

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None or layer_idx < self.moe.first_k_dense:
            return False
        return (layer_idx - self.moe.first_k_dense) % self.moe.layer_period == 0

    def total_params(self) -> int:
        p = self.vocab_size * self.d_model                # embedding
        if not self.tie_embeddings:
            p += self.vocab_size * self.d_model           # unembed
        for i in range(self.num_layers):
            p += self.layer_params(i)
        if self.encoder_layers:
            enc_layer = self._attn_params() + self._ffn_params(self.d_ff)
            cross = self._attn_params() if self.cross_attention else 0
            p += self.encoder_layers * enc_layer + self.num_layers * cross
        return p

    def active_params(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.total_params()
        p = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        m = self.moe
        for i in range(self.num_layers):
            p += self._attn_params()
            if self.parallel_ssm:
                p += self._ssm_params()
            if self.is_moe_layer(i):
                p += (m.experts_per_token + m.num_shared_experts) * 3 * self.d_model * m.d_ff_expert
                p += self.d_model * m.num_experts
            else:
                p += self._ffn_params(self.d_ff)
        return p


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 128,
            vocab: int = 256) -> ArchConfig:
    """Smoke-test-sized config of the same family (CPU-runnable)."""
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, heads // max(1, cfg.num_heads // max(1, cfg.num_kv_heads)))
    if heads % kv:
        kv = 1
    changes: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=d_model * 2,
        vocab_size=vocab,
        head_dim=d_model // heads,
        frontend_seq=8 if cfg.frontend else 0,
        encoder_layers=min(2, cfg.encoder_layers),
        attn_window=(32 if cfg.attn_window else None),
        remat="none",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            experts_per_token=min(2, cfg.moe.experts_per_token),
            d_ff_expert=d_model,
            first_k_dense=min(1, cfg.moe.first_k_dense),
        )
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=d_model // heads,
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk=16
        )
    return dataclasses.replace(cfg, **changes)
