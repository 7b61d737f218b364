"""Wrapper of kernel K8 (``csrc/token_sample.cu``): Gumbel-max token
sampling over LM logits, the decode step's sampler.

Sampling a token from ``softmax(logits / T)`` is eRVS's exponential-key
selection with w̃_v = exp(logit_v / T): in the log domain the key
``argmax_v u_v^(1/w̃_v)`` is ``argmax_v (logit_v / T + g_v)`` with Gumbel
noise ``g_v = -ln(-ln u_v)`` — no softmax, no normalisation, one pass
over the vocab.  ``token_sample`` runs the plain version
``ref.token_sample_ref`` on CPU tensors; on CUDA tensors it launches K8
(building it on first use) or raises.

At decode batch 8 the kernel reads 4.9 MB in a few microseconds, so the
wrapper's own host work is most of a call: it checks its inputs with a
few attribute reads, allocates only the output, and keeps K8's scratch —
a (key, index) pair per (row, chunk) and an arrival counter per row — per
(device, stream) across calls (``build.scratch``): the counters are zero
when allocated and the kernel leaves them zero.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, ref

#: tokens one K8 block reads (``kTokenChunk`` in ``csrc/token_sample.cu``)
TOKEN_CHUNK = 4096


def chunks_of(vocab: int) -> int:
    """K8's blocks per row of ``vocab`` logits."""
    return -(-vocab // TOKEN_CHUNK)


def _check(logits: torch.Tensor, seed: torch.Tensor) -> None:
    """Raise with the reason the inputs are not what K8 takes."""
    dev = logits.device
    if logits.dim() != 2 or logits.shape[1] == 0:
        raise ValueError(f"logits must be [B, V] with V > 0, got "
                         f"{tuple(logits.shape)}")
    build.require(logits, "logits", torch.float32, tuple(logits.shape), dev)
    build.require(seed, "seed", torch.int64, (2,), dev)


def token_sample(logits: torch.Tensor, seed: torch.Tensor,
                 temperature: float = 1.0,
                 greedy: bool = False) -> torch.Tensor:
    """Token ids [B] int32 from logits [B, V] float32: categorical at
    temperature ``temperature`` (Gumbel-max keys), or the arg-max when
    ``greedy``.  ``seed`` is [2] int64 holding uint32; row b draws from
    the Threefry key ``(seed0 + b mod 2^32, seed1)``."""
    if logits.is_cpu:
        return ref.token_sample_ref(logits, seed, temperature, greedy)
    if (logits.dtype != torch.float32 or logits.dim() != 2
            or seed.dtype != torch.int64 or seed.shape != (2,)
            or not logits.is_contiguous() or not seed.is_contiguous()
            or seed.get_device() != logits.get_device()
            or logits.shape[1] == 0):
        _check(logits, seed)
    B, V = logits.shape
    out = logits.new_empty((B,), dtype=torch.int32)
    if B == 0:
        return out
    chunks = chunks_of(V)
    if B * chunks >= 2**31:
        raise ValueError(f"[{B}, {V}] logits need {B * chunks} K8 blocks; "
                         f"the grid takes fewer than 2^31")
    dev = logits.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    pairs = B * chunks
    part_key = build.scratch("token_sample.key", dev, stream, pairs,
                             torch.float32)
    part_idx = build.scratch("token_sample.index", dev, stream, pairs,
                             torch.int32)
    arrived = build.scratch("token_sample.arrived", dev, stream, B,
                            torch.int32)
    inv_t = 0.0 if greedy else float(np.float32(1.0 / temperature))
    err = build.library("token_sample").repro_token_sample(
        logits.data_ptr(), seed.data_ptr(), B, V, chunks, inv_t, int(greedy),
        part_key.data_ptr(), part_idx.data_ptr(), arrived.data_ptr(),
        out.data_ptr(), stream)
    build.check(err, "token_sample")
    build.LAUNCHES["token_sample"] += 1
    return out
