"""Model configuration: one frozen dataclass describes every supported arch.

The ten assigned architectures (plus reduced smoke variants) are instances of
:class:`ModelConfig`; the block layout is selected by ``family``:

  dense   -- GQA attention + SwiGLU MLP decoder (stablelm, starcoder2,
             mistral-large, and the qwen2-vl backbone with M-RoPE)
  moe     -- GQA attention + top-k routed experts (olmoe, phi3.5-moe)
  hybrid  -- Mamba2 backbone with a *shared* attention block applied every
             ``attn_every`` layers (zamba2)
  ssm     -- attention-free RWKV6 time-mix/channel-mix (rwkv6)
  audio   -- encoder-only transformer over precomputed frame embeddings
             (hubert; the conv frontend is a stub per the assignment)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int

    # Attention / positions
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    mrope_sections: Optional[tuple] = None   # qwen2-vl M-RoPE (t, h, w)
    sliding_window: int = 0        # 0 -> full attention

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2) / hybrid
    ssm_state: int = 0             # N: state size per head
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_head_dim: int = 64         # P: channels per SSD head
    ssm_conv: int = 4              # depthwise conv window
    attn_every: int = 6            # hybrid: shared attn block cadence

    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 32

    # Encoder-only (audio): no causal mask, no decode path.
    encoder_only: bool = False
    # Modality frontend stub: inputs arrive as embeddings, not token ids.
    embed_inputs: bool = False

    # Numerics / activations
    activation: str = "swiglu"     # swiglu | gelu | relu2
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"        # parameter/compute dtype

    # Training defaults (overridable per run)
    remat: str = "full"            # full | dots | none

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode (O(1)-state or hybrid)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D MODEL_FLOPS)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.resolved_head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d
        mlp_mats = 3 if self.activation == "swiglu" else 2
        mlp = mlp_mats * d * f
        per_layer = 0.0
        if self.family in ("dense", "vlm"):
            per_layer = attn + mlp + 2 * d
        elif self.family == "audio":
            per_layer = attn + mlp + 4 * d
        elif self.family == "moe":
            router = d * self.n_experts
            per_layer = attn + router + self.n_experts * mlp + 2 * d
        elif self.family == "hybrid":
            di, n = self.d_inner, self.ssm_state
            h = self.ssm_heads
            in_proj = d * (2 * di + 2 * n + h)
            per_layer = (in_proj + self.ssm_conv * (di + 2 * n) +
                         di * d + 3 * h + 2 * d)
        elif self.family == "ssm":
            r = self.rwkv_lora_rank
            tm = 4 * d * d + d * d + 6 * (d * r + r * d) + 4 * d
            cm = 2 * d * f * 0 + d * f + f * d + 2 * d   # relu^2 channel-mix
            per_layer = tm + cm
        total = self.n_layers * per_layer + v * d + 2 * d
        if not self.tie_embeddings:
            total += d * v
        if self.family == "hybrid":  # shared attention block
            total += attn + mlp + 2 * d
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp_mats = 3 if self.activation == "swiglu" else 2
        expert = mlp_mats * d * f
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return int(self.param_count() - inactive)


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests."""
    base = dict(
        n_layers=2 if cfg.family != "hybrid" else 4,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_heads else 0,
        d_ff=128,
        vocab=256,
        head_dim=16 if cfg.n_heads else 0,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        capacity_factor=8.0,   # no token dropping in smoke tests
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=16,
        rwkv_head_dim=16,
        rwkv_lora_rank=8,
        attn_every=2,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else None,
        dtype="float32",
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
