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
uint32 add or shift on the CPU, so the rounds run on int32 tensors holding
the same bits (adds wrap; a right shift is masked to act as a logical
one), half the bytes of int64 and no mask after every add, and results
come back as int64; ``csrc/threefry.cuh`` is the same generator as device
code.
"""
from __future__ import annotations

from typing import Optional

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _bits32(x):
    """``x`` mod 2**32 as int32 bits: an int32 tensor, or an int in
    int32's range."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32:
            return x
        x = x.long() & MASK32
        return (x - ((x >> 31) << 32)).to(torch.int32)
    x = int(x) & MASK32
    return x - (1 << 32) if x >> 31 else x


def _add(a, b):
    """a + b mod 2**32 on int32 bits (tensor adds wrap)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a + b
    return _bits32(a + b)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry32(k0, k1, x0, x1):
    """:func:`threefry2x32` with int32 bits in and out."""
    ts = [v for v in (k0, k1, x0, x1) if isinstance(v, torch.Tensor)]
    dev = ts[0].device if ts else None
    k0, k1, x0, x1 = map(_bits32, (k0, k1, x0, x1))
    k2 = _bits32(k0 ^ k1 ^ _PARITY)
    ks = (k0, k1, k2)
    x0 = _add(x0, k0)
    x1 = _add(x1, k1)
    if not isinstance(x1, torch.Tensor):
        x1 = torch.tensor(x1, dtype=torch.int32, device=dev)
    for block in range(5):
        for r in range(4):
            x0 = _add(x0, x1)
            x1 = _rotl(x1, _ROTATIONS[(block % 2) * 4 + r]) ^ x0
        inj = block + 1
        x0 = _add(x0, ks[inj % 3])
        x1 = _add(x1, _add(ks[(inj + 1) % 3], inj))
    return x0, x1


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits as the int64 uint32 value."""
    return x.long() & MASK32


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 on int64 tensors (or ints) holding uint32
    values: (key0, key1, ctr0, ctr1) -> (r0, r1) as int64 tensors holding
    uint32 values, broadcast."""
    r0, r1 = _threefry32(k0, k1, x0, x1)
    return _u32(r0), _u32(r1)


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


def _bits_of(key: torch.Tensor, n: Optional[int]) -> torch.Tensor:
    """:func:`random_bits` as int32 bits."""
    if n is None:
        r0, r1 = _threefry32(key[..., 0], key[..., 1], 0, 0)
    else:
        ctr = torch.arange(n, dtype=torch.int32, device=key.device)
        r0, r1 = _threefry32(key[..., 0, None], key[..., 1, None], 0, ctr)
    return r0 ^ r1


def random_bits(key: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` per key (``[..., n]``), or the scalar
    draw (``[...]``, counter 0) when ``n`` is None."""
    return _u32(_bits_of(key, n))


def uniform(key: torch.Tensor, n: Optional[int] = None,
            minval: float = 1e-12, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` per key:
    23 mantissa bits into [1, 2), minus 1, scaled and clamped exactly as
    jax does it (separate multiply and add, never fused)."""
    return _scale(_mantissa(_bits_of(key, n)), minval, maxval)


def _mantissa(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 of 32 random bits (int32 or int64) as a float32 in
    [1, 2)."""
    return (((bits >> 9) & 0x7FFFFF) | 0x3F800000).to(torch.int32) \
        .view(torch.float32)


def _scale(f: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    f = f - _f32(1.0)
    lo, hi = _f32(minval), _f32(maxval)
    return torch.maximum(lo.to(f.device), f * (hi - lo) + lo)


def uniform_from_bits(bits: torch.Tensor, minval: float = 1e-12,
                      maxval: float = 1.0) -> torch.Tensor:
    """The float32 map of :func:`uniform` applied to given random bits."""
    return _scale(_mantissa(bits), minval, maxval)
