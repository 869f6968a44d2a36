"""Unified architecture configuration for the assigned model pool."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"  # silu (gated) | gelu (gated) | relu2 (non-gated)
    gated_mlp: bool = True
    norm_eps: float = 1e-5
    rope_theta: float = 1_000_000.0
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    ssm_conv: int = 4
    d_inner: int = 0  # 0 -> 2*d_model
    # --- hybrid (zamba2-style shared attention block) ---
    attn_every: int = 0  # insert shared attn block every N ssm layers
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_frames_max: int = 0  # encoder input length cap (stub frontend)
    learned_pos: bool = False
    # --- VLM ---
    mrope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # pairs per (t,h,w)
    img_frac: float = 0.25  # fraction of seq filled by patch embeddings

    # ------------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token decode cell?"""
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_heads(self) -> int:
        di = self.d_inner or 2 * self.d_model
        return di // self.ssm_headdim

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim * d
            mlp = d * ff * (3 if self.gated_mlp else 2)
            return L * (attn + mlp) + emb
        if self.family == "moe":
            attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim * d
            eff = self.expert_d_ff or ff
            moe = (self.n_experts + self.n_shared_experts) * d * eff * 3 + d * self.n_experts
            return L * (attn + moe) + emb
        if self.family == "ssm":
            di = self.d_inner or 2 * d
            per = d * (2 * di + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads) + di * d
            return L * per + emb
        if self.family == "hybrid":
            di = self.d_inner or 2 * d
            ssm = d * (2 * di + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads) + di * d
            attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim * d
            mlp = d * ff * 3
            return L * ssm + (attn + mlp) + emb  # one shared block
        if self.family == "encdec":
            attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim * d
            mlp = d * ff * 2
            enc = self.n_enc_layers * (attn + mlp)
            dec = self.n_layers * (2 * attn + mlp)
            return enc + dec + emb
        raise ValueError(self.family)

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top-k experts only)."""
        if self.family != "moe":
            return self.n_params()
        d, V, L = self.d_model, self.vocab, self.n_layers
        emb = V * d * 2
        attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim * d
        eff = self.expert_d_ff or self.d_ff
        act = (self.moe_top_k + self.n_shared_experts) * d * eff * 3 + d * self.n_experts
        return L * (attn + act) + emb

    def reduced(self, seed_dims: Optional[dict] = None) -> "ArchConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1))),
            head_dim=16,
            d_ff=128,
            vocab=256,
            name=self.name + "-smoke",
        )
        if self.family == "moe":
            kw.update(n_experts=8, n_shared_experts=min(self.n_shared_experts, 1), moe_top_k=2, expert_d_ff=32)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_headdim=16, d_inner=128, ssm_chunk=16, attn_every=2 if self.attn_every else 0)
        if self.family == "encdec":
            kw.update(n_enc_layers=2, n_frames_max=64)
        if seed_dims:
            kw.update(seed_dims)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
