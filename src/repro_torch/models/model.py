"""Decoder assembly and the decode path (port of ``repro/models/model.py``,
the part serving runs).

The layer stack is organised as *segments*, maximal runs of one layer
kind (``segment_plan``), as in the reference; a dense model is one
segment of ``attn`` layers.  The reference stacks a segment's parameters
``[reps, ...]`` to scan over them; here each layer is its own
``Block`` module and the loop is Python.  Each segment's KV cache is one
preallocated ``[L, B, Smax, G, hd]`` K and V buffer, and ``decode_step``
writes the new token's K/V into it in place: the reference's ``unroll``
path, without the scan's per-layer cache copies.

Only ``attn`` layers are ported (the dense, vlm and audio families).
``moe``, ``rec`` and ``mamba`` layers raise ``NotImplementedError``; they
are listed in ROADMAP.md queue 1 (the LM side-stack), as are ``forward``
and ``prefill``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

F32 = torch.float32
PORTED_KINDS = ("attn",)


# ----------------------------------------------------------------- plan
def segment_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    kinds = cfg.layer_kinds()
    if cfg.family == "hybrid" and cfg.block_pattern:
        g = len(cfg.block_pattern)
        full = cfg.num_layers // g
        plan = [(tuple(cfg.block_pattern), full)]
        rem = cfg.num_layers % g
        if rem:
            plan.append((tuple(cfg.block_pattern[:rem]), 1))
        return plan
    # group identical consecutive kinds
    plan: List[Tuple[Tuple[str, ...], int]] = []
    for kind in kinds:
        if plan and plan[-1][0] == (kind,):
            plan[-1] = ((kind,), plan[-1][1] + 1)
        else:
            plan.append(((kind,), 1))
    return plan


def _ported_plan(cfg: ModelConfig) -> List[int]:
    """Layers per segment; raises for a layer kind the port lacks."""
    plan = segment_plan(cfg)
    missing = sorted({k for kinds, _ in plan for k in kinds} -
                     set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) has {missing} layers, which the "
            f"PyTorch port does not implement yet (ROADMAP.md queue 1, the "
            f"LM side-stack); it serves {list(PORTED_KINDS)} layers only")
    return [reps for _, reps in plan]


# ---------------------------------------------------------------- params
class Block(nn.Module):
    """One ``attn`` layer: norm1, attention, norm2, MLP."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.norm1 = L.empty_weight((cfg.d_model,), F32, device)
        self.attn = L.Attention(cfg, device)
        self.norm2 = L.empty_weight((cfg.d_model,), F32, device)
        self.mlp = L.MLP(cfg, device)


class DecoderLM(nn.Module):
    """The model's parameters: ``embed`` [V, D], ``final_norm`` [D], the
    untied ``lm_head`` [D, V] (None when tied), and ``segments``, one
    ``ModuleList`` of ``Block``s per segment of :func:`segment_plan`.

    :meth:`build_head` keeps the head in float32 beside them
    (``head_f32``, [V, D]: the embedding itself when tied, else
    ``lm_head`` transposed) — V·D·4 bytes, 622 MB for qwen3-0.6b — so that
    a decode step does not convert it again."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        reps = _ported_plan(cfg)
        dt = L.torch_dtype(cfg)
        self.embed = L.empty_weight((cfg.vocab_size, cfg.d_model), dt, device)
        self.final_norm = L.empty_weight((cfg.d_model,), F32, device)
        self.lm_head = None if cfg.tie_embeddings else L.empty_weight(
            (cfg.d_model, cfg.vocab_size), dt, device)
        self.segments = nn.ModuleList(
            nn.ModuleList(Block(cfg, device) for _ in range(n))
            for n in reps)
        self.head_f32: Optional[torch.Tensor] = None

    def build_head(self) -> None:
        """(Re)build ``head_f32`` from the current weights;
        :func:`init_params` and ``interop.params_from_arrays`` call it."""
        head = self.embed if self.lm_head is None else self.lm_head.t()
        self.head_f32 = head.detach().to(F32).contiguous()


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> DecoderLM:
    """Random parameters on ``device``, drawn from ``generator`` (which
    must live there), with the reference's scales and dtypes: normal
    embedding and head scaled by d_model^-0.5, each projection by its
    fan-in^-0.5, cast to ``cfg.dtype``; zero norm scales (the norms
    multiply by ``1 + w``) in float32.  The draws are torch's, not jax's:
    ``interop.params_from_arrays`` brings in the reference's own."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"parameters are asked for on {device}")
    model = DecoderLM(cfg, device)
    L.normal_(model.embed, cfg.d_model ** -0.5, generator)
    model.final_norm.zero_()
    if model.lm_head is not None:
        L.normal_(model.lm_head, cfg.d_model ** -0.5, generator)
    for seg in model.segments:
        for blk in seg:
            blk.norm1.zero_()
            blk.norm2.zero_()
            L.init_attention(blk.attn, cfg, generator)
            L.init_mlp(blk.mlp, cfg, generator)
    model.build_head()
    return model


# ------------------------------------------------------------- blocks
def _res_scale(cfg: ModelConfig) -> float:
    if cfg.scale_depth > 0:
        return cfg.scale_depth / (cfg.num_layers ** 0.5)
    return 1.0


def _apply_block_decode(blk: Block, cfg: ModelConfig, x: torch.Tensor,
                        k_cache: torch.Tensor, v_cache: torch.Tensor,
                        index: int) -> torch.Tensor:
    s = _res_scale(cfg)
    h = L.attention_decode(blk.attn, cfg, L.rms_norm(x, blk.norm1),
                           k_cache, v_cache, index)
    x = x + s * h
    x = x + s * L.mlp_fwd(blk.mlp, L.rms_norm(x, blk.norm2))
    return x


# -------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> List[Dict[str, torch.Tensor]]:
    """One ``{"k", "v"}`` pair of zero ``[L, batch, max_len, G, hd]``
    buffers per segment (``L`` its layers)."""
    return [dict(zip(("k", "v"), L.init_kv_cache(cfg, batch, max_len, n,
                                                  device)))
            for n in _ported_plan(cfg)]


@torch.no_grad()
def decode_step(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                caches: List[Dict[str, torch.Tensor]], index: int):
    """tokens [B, 1] + caches + position ``index`` -> (logits [B, V]
    float32, caches).  The caches are updated in place at ``index`` and
    returned.  Logits are ``x.float() @ head.float()`` through the
    float32 head :meth:`DecoderLM.build_head` keeps."""
    x = params.embed[tokens.long()].to(L.torch_dtype(cfg))
    for seg, cache in zip(params.segments, caches):
        for r, blk in enumerate(seg):
            x = _apply_block_decode(blk, cfg, x, cache["k"][r],
                                    cache["v"][r], index)
    x = L.rms_norm(x, params.final_norm)
    logits = x[:, 0].to(F32) @ params.head_f32.t()
    return logits, caches
