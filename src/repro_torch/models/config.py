"""Unified model configuration covering all assigned architecture families
(the port's own copy of ``repro/models/config.py``: pure data, the same
fields and derived properties).

One config dataclass describes dense GQA (llama-family), qk-norm GQA
(qwen3), MoE (DeepSeek-V3-style routed+shared experts), RG-LRU hybrids
(recurrentgemma/griffin), Mamba2 SSD, and the early-fusion VLM / EnCodec
audio backbones (whose modality frontends are stubs per the assignment —
``input_specs`` provides token ids / precomputed embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (0 heads for attention-free archs)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 0  # >0: sliding-window attention
    # dense FFN
    d_ff: int = 0
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_experts: int = 0
    num_dense_layers: int = 0  # dense lead-in layers (DeepSeek/Kimi style)
    capacity_factor: float = 1.25
    router: str = "topk"  # "topk" | "sampled" (eRVS Gumbel-top-k router)
    # hybrid (RG-LRU): repeating pattern of block kinds
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec","rec","attn")
    lru_width: int = 0
    conv_width: int = 4
    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    d_inner: int = 0
    # embeddings / head
    tie_embeddings: bool = False
    # minicpm-style depth scaling of residual branches
    scale_depth: float = 0.0
    # numerics
    dtype: str = "bfloat16"
    # training
    max_seq_len: int = 4096

    # ----------------------------------------------------------- derived
    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True for sub-quadratic decode state (SSM / hybrid local-attn)."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer, in order."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("mamba")
            elif self.family == "hybrid" and self.block_pattern:
                kinds.append(self.block_pattern[i % len(self.block_pattern)])
            elif self.num_experts > 0 and i >= self.num_dense_layers:
                kinds.append("moe")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        n = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for kind in self.layer_kinds():
            n += self._layer_params(kind)
        n += self.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (= param_count for non-MoE)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for kind in self.layer_kinds():
            n += self._layer_params(kind, active_only=True)
        n += self.d_model
        return n

    def _layer_params(self, kind: str, active_only: bool = False) -> int:
        D = self.d_model
        n = 2 * D  # two rms norms
        if kind == "attn" or (kind == "moe"):
            qkvo = D * self.attn_dim * 2 + D * self.kv_dim * 2
            if self.qk_norm:
                qkvo += 2 * self.head_dim
            n += qkvo
        if kind == "attn":
            n += 3 * D * self.d_ff
        elif kind == "moe":
            e = self.experts_per_token if active_only else self.num_experts
            n += 3 * D * self.moe_d_ff * (e + self.shared_experts)
            n += D * self.num_experts  # router
        elif kind == "rec":
            W = self.lru_width
            n += 2 * D * W + W * D  # in (x,gate) + out
            n += self.conv_width * W + 3 * W  # conv + lru gates/Lambda
            n += 3 * D * self.d_ff  # the block's MLP
        elif kind == "mamba":
            din = self.d_inner
            H = din // self.ssm_head_dim
            N = self.ssm_state
            n += D * (2 * din + 2 * self.ssm_groups * N + H)  # in_proj
            n += self.conv_width * (din + 2 * self.ssm_groups * N)
            n += 2 * H + din  # A_log, D, norm
            n += din * D  # out_proj
        return n
