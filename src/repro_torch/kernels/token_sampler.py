"""Wrapper of kernel K8 (``csrc/token_sample.cu``): Gumbel-max token
sampling over LM logits, the decode step's sampler.

Sampling a token from ``softmax(logits / T)`` is eRVS's exponential-key
selection with w̃_v = exp(logit_v / T): in the log domain the key
``argmax_v u_v^(1/w̃_v)`` is ``argmax_v (logit_v / T + g_v)`` with Gumbel
noise ``g_v = -ln(-ln u_v)`` — no softmax, no normalisation, one pass
over the vocab.  ``token_sample`` runs the plain version
``ref.token_sample_ref`` on CPU tensors; on CUDA tensors it launches K8
(building it on first use) or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, ref


def token_sample(logits: torch.Tensor, seed: torch.Tensor,
                 temperature: float = 1.0,
                 greedy: bool = False) -> torch.Tensor:
    """Token ids [B] int32 from logits [B, V] float32: categorical at
    temperature ``temperature`` (Gumbel-max keys), or the arg-max when
    ``greedy``.  ``seed`` is [2] int64 holding uint32; row b draws from
    the Threefry key ``(seed0 + b mod 2^32, seed1)``."""
    if logits.device.type == "cpu":
        return ref.token_sample_ref(logits, seed, temperature, greedy)
    dev = logits.device
    if logits.dim() != 2 or logits.shape[1] == 0:
        raise ValueError(f"logits must be [B, V] with V > 0, got "
                         f"{tuple(logits.shape)}")
    B, V = logits.shape
    build.require(logits, "logits", torch.float32, (B, V), dev)
    build.require(seed, "seed", torch.int64, (2,), dev)
    inv_t = 0.0 if greedy else float(np.float32(1.0 / temperature))
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = build.library("token_sample")
    chunks = lib.repro_token_sample_chunks(V)
    if chunks > 65535:
        raise ValueError(f"a vocab of {V} needs {chunks} chunks; K8's grid "
                         f"takes at most 65,535")
    part_key = torch.empty((B, chunks), dtype=torch.float32, device=dev)
    part_idx = torch.empty((B, chunks), dtype=torch.int32, device=dev)
    err = lib.repro_token_sample(
        logits.data_ptr(), seed.data_ptr(), B, V, inv_t, int(greedy),
        part_key.data_ptr(), part_idx.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "token_sample")
    build.LAUNCHES["token_sample"] += 1
    return out
