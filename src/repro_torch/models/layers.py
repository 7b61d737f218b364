"""Model building blocks of the dense decoder (port of the dense subset of
``repro/models/layers.py``): norms, rotary embedding, GQA attention for
one decode token against a KV cache, and the gated MLP.

Numerics as in the reference: parameters and activations in the config's
dtype (bf16 for the published configs), norms, rotary angles, attention
scores and softmax in float32.  The reference's bf16 products with float32
accumulation (``preferred_element_type``) are float32 products of the bf16
values here: a bf16 product is exact in float32, so only the order of the
float32 sums differs.  The reference's sharding annotations (``shard``,
``tp_down_proj``) have no counterpart on one card: a projection is ``x @
w``.  Prefill (``attention_fwd``, ``flash_attention``), MoE, RG-LRU and
Mamba2 blocks are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

F32 = torch.float32


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype`` ("bfloat16", "float32", ...)."""
    return getattr(torch, cfg.dtype)


def empty_weight(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter that takes no gradient (serving only)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def normal_(w: torch.Tensor, scale: float, gen: torch.Generator) -> None:
    """w <- (standard normal float32 draws * scale) cast to w's dtype."""
    w.copy_(torch.randn(w.shape, generator=gen, dtype=F32, device=w.device)
            * scale)


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the ``(1 + w)`` scale, cast back to
    ``x``'s dtype."""
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.to(F32))
    return out.to(x.dtype)


# ------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding in float32.  x: [..., S, H, D];
    positions: [..., S] (broadcastable)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                     / half)
    ang = positions[..., :, None].to(F32) * freq  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention
class Attention(nn.Module):
    """GQA projections: wq [D, H·hd], wk / wv [D, G·hd], wo [H·hd, D], and
    with qk-norm the float32 scales q_norm / k_norm [hd]."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        D, A, KV = cfg.d_model, cfg.attn_dim, cfg.kv_dim
        dt = torch_dtype(cfg)
        self.wq = empty_weight((D, A), dt, device)
        self.wk = empty_weight((D, KV), dt, device)
        self.wv = empty_weight((D, KV), dt, device)
        self.wo = empty_weight((A, D), dt, device)
        if cfg.qk_norm:
            self.q_norm = empty_weight((cfg.head_dim,), F32, device)
            self.k_norm = empty_weight((cfg.head_dim,), F32, device)


def init_attention(p: Attention, cfg: ModelConfig,
                   gen: torch.Generator) -> None:
    """The reference's init: normal weights scaled by fan-in^-0.5, cast
    to the config's dtype; zero qk-norm scales."""
    for w, fan_in in ((p.wq, cfg.d_model), (p.wk, cfg.d_model),
                      (p.wv, cfg.d_model), (p.wo, cfg.attn_dim)):
        normal_(w, fan_in ** -0.5, gen)
    if cfg.qk_norm:
        p.q_norm.zero_()
        p.k_norm.zero_()


def _qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    B, S, _ = x.shape
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, H, hd)
    k = (x @ p.wk).reshape(B, S, G, hd)
    v = (x @ p.wv).reshape(B, S, G, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     index: int) -> torch.Tensor:
    """One decode token.  x: [B, 1, D]; k_cache / v_cache: [B, Smax, G, hd]
    of this layer, updated IN PLACE at position ``index`` (the reference
    returns new caches; here the caller's buffers take the token's K/V).
    Keys at positions ``<= index`` are attended to.  Returns [B, 1, D].

    Scores and softmax in float32; the probabilities are cast to the
    cache's dtype before the product with V, as in the reference."""
    B = x.shape[0]
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = H // G
    pos = torch.full((B, 1), int(index), dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, pos)
    k_cache[:, index] = k_new[:, 0]
    v_cache[:, index] = v_new[:, 0]
    Smax = k_cache.shape[1]
    valid = torch.arange(Smax, device=x.device) <= index
    qf = q.reshape(B, G, rep, hd).to(F32)
    s = qf @ k_cache.to(F32).permute(0, 2, 3, 1)  # [B, G, rep, Smax]
    s = s * hd ** -0.5
    s = s.masked_fill(~valid, float("-inf"))
    w = torch.softmax(s, dim=-1).to(k_cache.dtype)
    out = w.to(F32) @ v_cache.to(F32).permute(0, 2, 1, 3)  # [B, G, rep, hd]
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ p.wo


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int,
                  device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero K and V buffers [layers, batch, max_len, G, hd] of a segment of
    ``layers`` attention layers, preallocated once."""
    device = resolve_device(device)
    shape = (layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


# ------------------------------------------------------------------- mlp
class MLP(nn.Module):
    """Gated MLP: wi / wg [D, F], wd [F, D]."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        D, F = cfg.d_model, cfg.d_ff
        dt = torch_dtype(cfg)
        self.wi = empty_weight((D, F), dt, device)
        self.wg = empty_weight((D, F), dt, device)
        self.wd = empty_weight((F, D), dt, device)


def init_mlp(p: MLP, cfg: ModelConfig, gen: torch.Generator) -> None:
    for w, fan_in in ((p.wi, cfg.d_model), (p.wg, cfg.d_model),
                      (p.wd, cfg.d_ff)):
        normal_(w, fan_in ** -0.5, gen)


def mlp_fwd(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """``silu(x @ wg) * (x @ wi)`` in float32, cast, ``@ wd``."""
    h = torch.nn.functional.silu((x @ p.wg).to(F32)) * (x @ p.wi).to(F32)
    return h.to(x.dtype) @ p.wd
