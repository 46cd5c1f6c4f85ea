"""Model configuration schema covering every assigned architecture family
(the port of ``repro.configs.base``; ``jdtype`` is a ``torch.dtype``)."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

__all__ = ["ModelConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_np (non-parametric)
    act: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    dense_ff: int = 0  # hidden of the dense-residual MLP
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"  # einsum (GShard) | scatter (gather-based)
    moe_group_size: int = 1024  # GShard dispatch group
    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Hymba) ------------------------------------------------------
    attn_window: int = 0  # sliding-window size for SWA layers (0 = full)
    global_layers: tuple[int, ...] = ()  # full-attention layer indices
    # --- frontend stub -------------------------------------------------------
    frontend: str = "none"  # none | audio_tokens | vision_patch
    # --- distribution (set by the launcher per mesh/shape, not arch files) ---
    # (batch_axes, seq_axes, vocab_axis): activation sharding constraints
    # applied at layer boundaries; None -> unconstrained (single-device runs).
    act_spec: tuple | None = None
    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    loss_dtype: str = "float32"  # dtype of the loss-chunk logits
    kv_dtype: str = "bfloat16"  # "int8": quantized KV cache + int8 attention
    #   (the paper's in-cache quantization applied to the decode cache:
    #    per-(position, head) scales, int8 QK^T and PV matmuls on the MXU)
    loss_vocab_tp: bool = False  # reshard the loss region seq->vocab TP
    #   (keeps dW_head shard-local instead of all-reducing it per chunk)
    megatron_sp: bool = False  # gather seq-sharded acts at block entry so
    #   the TP GEMMs run on full-sequence activations with *sharded* weights
    #   (otherwise GSPMD replicates the ff weights per layer under SP)
    remat: str = "none"  # none | full | dots  (activation checkpoint policy)
    attn_chunk_q: int = 1024  # flash-attention tile sizes (pure-JAX scan)
    attn_chunk_kv: int = 1024

    # ---- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads if self.n_kv_heads else 0

    @property
    def jdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameters (embedding + layers + head), analytic."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, H, Hkv = self.hd, self.n_heads, self.n_kv_heads
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # head
        per_layer = 0
        if self.has_attention:
            per_layer += d * (H * hd) + 2 * d * (Hkv * hd) + (H * hd) * d
            if self.qkv_bias:
                per_layer += (H + 2 * Hkv) * hd
        if self.family == "hybrid" or self.family == "ssm":
            di, N, P = self.d_inner, self.ssm_state, self.ssm_head_dim
            nh = self.ssm_heads
            # in_proj -> [z, x, B, C, dt], conv, dt bias, A, D, norm, out_proj
            per_layer += d * (2 * di + 2 * N + nh) + self.ssm_conv * (di + 2 * N)
            per_layer += 2 * nh + di + di * d
        if self.is_moe:
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * (3 * d * ff if self.act == "swiglu" else 2 * d * ff)
            if self.moe_dense_residual:
                dff = self.dense_ff or 2 * d
                per_layer += 3 * d * dff
        elif ff > 0:
            per_layer += 3 * d * ff if self.act == "swiglu" else 2 * d * ff
        n += self.n_layers * per_layer
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        expert = 3 * d * ff if self.act == "swiglu" else 2 * d * ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
