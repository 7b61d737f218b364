"""Counter-based Threefry-2x32, bit-compatible with the JAX reference.

Two families of draws share one generator:

* the kernels' own uniforms (:func:`uniform_01`, :func:`uniform_pair_01`,
  the reference's ``kernels/prng.py``), used by the table draws;
* jax's staged draws, which the reference's staged step takes from
  ``jax.random`` with ``jax_threefry_partitionable=True``:
  ``fold_in(k, d) = threefry(k, (0, d))``, ``bits(k, (n,))[i] = r0 ^ r1``
  of ``threefry(k, (0, i))`` (a scalar draw uses counter ``(0, 0)``), and
  ``uniform(minval=1e-12)`` built from those bits (:func:`uniform`).

Keys are ``[..., 2]`` int64 tensors holding uint32 values.  torch has no
uint32 add or shift on the CPU, so the arithmetic runs in int64 masked to
32 bits; ``csrc/threefry.cuh`` is the same generator as device code.
"""
from __future__ import annotations

from typing import Optional

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 on int64 tensors (or ints) holding uint32
    values: (key0, key1, ctr0, ctr1) -> (r0, r1), broadcast."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for block in range(5):
        for r in range(4):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, _ROTATIONS[(block % 2) * 4 + r]) ^ x0
        inj = block + 1
        x0 = (x0 + ks[inj % 3]) & MASK32
        x1 = (x1 + ks[(inj + 1) % 3] + inj) & MASK32
    return x0, x1


def uniform_01(k0, k1, c0, c1) -> torch.Tensor:
    """U(0, 1) float32 from the top 24 bits of ``r0`` plus a half-ulp
    shift (never exactly 0) — the reference kernels' draw."""
    r0, _ = threefry2x32(k0, k1, c0, c1)
    f = (r0 >> 8).to(torch.float32)
    return f * _f32(1.0 / (1 << 24)) + _f32(0.5 / (1 << 24))


def uniform_pair_01(k0, k1, c0, c1):
    """Two independent U(0, 1) float32 draws from one Threefry call: the
    :func:`uniform_01` map applied to ``r0`` and to ``r1`` (the alias
    table draw's column and coin)."""
    r0, r1 = threefry2x32(k0, k1, c0, c1)
    scale, half = _f32(1.0 / (1 << 24)), _f32(0.5 / (1 << 24))
    return ((r0 >> 8).to(torch.float32) * scale + half,
            (r1 >> 8).to(torch.float32) * scale + half)


def key_data(seed: int) -> torch.Tensor:
    """Raw key data of ``jax.random.key(seed)`` for a 32-bit seed."""
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` on ``[..., 2]`` key data; ``data`` is an int
    or an int tensor broadcastable to ``key[..., 0]``."""
    r0, r1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(r0, r1), dim=-1)


def random_bits(key: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` per key (``[..., n]``), or the scalar
    draw (``[...]``, counter 0) when ``n`` is None."""
    if n is None:
        r0, r1 = threefry2x32(key[..., 0], key[..., 1], 0, 0)
    else:
        ctr = torch.arange(n, dtype=torch.int64, device=key.device)
        r0, r1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, ctr)
    return r0 ^ r1


def uniform(key: torch.Tensor, n: Optional[int] = None,
            minval: float = 1e-12, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` per key:
    23 mantissa bits into [1, 2), minus 1, scaled and clamped exactly as
    jax does it (separate multiply and add, never fused)."""
    return uniform_from_bits(random_bits(key, n), minval, maxval)


def uniform_from_bits(bits: torch.Tensor, minval: float = 1e-12,
                      maxval: float = 1.0) -> torch.Tensor:
    """The float32 map of :func:`uniform` applied to given random bits."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f = f - _f32(1.0)
    lo, hi = _f32(minval), _f32(maxval)
    return torch.maximum(lo.to(f.device), f * (hi - lo) + lo)
