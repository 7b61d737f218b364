"""Batched generation with the eRVS token sampler (port of
``repro/serving/engine.py``).

``make_serve_step`` builds the one-token decode step: embed -> layers
with the KV cache updated in place -> float32 logits -> sample.  Sampling
is the paper's exponential-key mechanism (Gumbel-max) through
``ops.token_sample``: kernel K8 on CUDA tensors, its plain version on CPU
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.prng import fold_in, key_data
from repro_torch.models import decode_step, init_cache
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    greedy: bool = False
    # the reference's switch between its Pallas kernel and interpret
    # mode; the port has no such mode (the sampler runs K8 on CUDA tensors
    # and its plain version on CPU tensors), so False is refused on the
    # card and changes nothing on the CPU
    use_pallas_sampler: bool = True


def sample_tokens(logits: torch.Tensor, seed: torch.Tensor,
                  temperature: float, greedy: bool) -> torch.Tensor:
    return ops.token_sample(logits, seed, temperature=temperature,
                            greedy=greedy)


def make_serve_step(cfg: ModelConfig, temperature: float = 1.0,
                    greedy: bool = False):
    """serve_step(params, tokens [B, 1], caches, index, seed) ->
    (next_tokens [B] int32, caches), the caches updated in place."""

    def serve_step(params, tokens, caches, index, seed):
        logits, caches = decode_step(params, cfg, tokens, caches, index)
        nxt = sample_tokens(logits, seed, temperature, greedy)
        return nxt, caches

    return serve_step


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor,
             gcfg: GenerateConfig, key: Optional[torch.Tensor] = None,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy or sampled generation for a [B, S0] prompt batch on the
    parameters' device.  Returns [B, S0 + max_new_tokens] int32 token
    ids, the prompts kept.

    As in the reference, the prompt tokens are fed through decode steps
    to fill the cache, so every position but the last takes one decode
    step and one sampler call (the draws at prompt positions are
    discarded).  ``key`` is raw key data [2] (``prng.key_data``; default
    ``key_data(0)``, the reference's ``jax.random.key(0)``); step i's
    sampler seed is the reference's ``make_seeds(fold_in(key, i), 1)[0]``.
    """
    dev = params.embed.device
    if not gcfg.use_pallas_sampler and dev.type == "cuda":
        raise ValueError("use_pallas_sampler=False asks for the plain "
                         "sampler on the card; the port samples on CUDA "
                         "tensors with kernel K8 only")
    B, S0 = prompt.shape
    total = S0 + gcfg.max_new_tokens
    max_len = max_len or total
    caches = init_cache(cfg, B, max_len, device=dev)
    step_fn = make_serve_step(cfg, gcfg.temperature, gcfg.greedy)
    # the seeds of all steps on the host: a few scalar Threefry calls
    key = (key_data(0) if key is None else key).to("cpu", torch.int64)
    seeds = torch.stack([ops.make_seeds(fold_in(key, i), 1)[0]
                         for i in range(total - 1)]).to(dev)
    out = torch.zeros((B, total), dtype=torch.int32, device=dev)
    out[:, :S0] = prompt.to(device=dev, dtype=torch.int32)
    tok = out[:, :1]
    for i in range(total - 1):
        nxt, caches = step_fn(params, tok, caches, i, seeds[i])
        if i + 1 >= S0:
            out[:, i + 1] = nxt
        tok = out[:, i + 1:i + 2]
    return out
