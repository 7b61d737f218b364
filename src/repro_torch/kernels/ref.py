"""Plain PyTorch versions of the standalone kernels (port of
``repro/kernels/ref.py``).

Each ``*_ref`` consumes the same Threefry counters and performs the same
float32 operations, one IEEE operation at a time, as its kernel:
:func:`ervs_select_ref` is the plain version of K6 (``csrc/ervs_block.cu``),
:func:`erjs_select_ref` of K7 (``csrc/erjs_block.cu``),
:func:`its_search_ref` and :func:`alias_pick_ref` of K3's and K5's aligned
entries (:func:`its_reads_ref` and :func:`alias_reads_ref` replay what
they read, for the kernels' bounds), :func:`token_sample_ref` of K8
(``csrc/token_sample.cu``).
:func:`ervs_select_semantic` is the textbook algorithm with a
``torch.Generator``, the distribution oracle of chi-square tests.

Layout: ``ops.align_rows`` — each node's row starts on a 128-lane boundary
of a [R, 128] stream; walker i's row lives at rows ``[row0_i, row0_i +
ceil(deg_i / 128))``.  Walkers are rows of their own: row0/degs are [W].
As in the reference, a read outside the stream is clipped to it: the
eRVS and eRJS versions clip the row index to ``[0, R)``, the ITS and
alias versions the flat index to ``[0, R * 128)``.

Sum and prefix-sum orders.  The reference sums and scans each masked
1024-weight tile with ``jnp.sum`` / ``jnp.cumsum``, which XLA on the CPU
evaluates in fixed orders that :func:`xla_sum` and :func:`xla_cumsum`
reproduce bit for bit: the sum adds 32 windows of 32 contiguous weights,
each sequentially from its first, then the 32 window sums sequentially;
the prefix sum is a recursive scan with base 16 (sequential inclusive
scans of 16-chunks, the chunk totals scanned the same way, each element
plus the exclusive prefix of its chunk).  So the tile's last prefix need
not equal its sum, and a crossing may find no position at or above its
target; it then takes position 0, as ``argmax`` of an all-false mask does.

Transcendentals.  XLA on the CPU evaluates ``exp`` and ``log`` with Cephes
polynomials (Eigen's ``pexp``/``plog`` for float32) and, on a host with
FMA, contracts every multiply feeding an add into one fused multiply-add —
the polynomials' steps and the reference's ``t_w + u1 * (1 - t_w)`` alike.
A 1-ulp difference there is not harmless: ``log(uu)`` of a ``uu`` near 1
turns it into a relative change of ~1e-4 in the next threshold, which
moves later crossings.  So :func:`xla_exp`, :func:`xla_log` and
:func:`fma32` reproduce those operations, and K1's jump instance, K6 and
K8 run the same operations on the card (``csrc/xla_math.cuh``, where
``fma32`` is the hardware's ``fmaf``).  :func:`fma32` is exact: a float64
multiply of float32 values, which is exact, a float64 add rounded to odd,
then one rounding to float32 — the float32 value a fused multiply-add
gives, ties included.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.prng import MASK32, uniform_01, uniform_pair_01

LANES = 128
SUBLANES = 8
TILE = LANES * SUBLANES  # 1024 weights per tile
#: rows of more weights are K6's "tabled" rows, whose tile sums and prefix
#: maxima its table pass builds once per distinct row; a walker on a
#: shorter row reads its row itself (kShortMax in csrc/ervs_block.cu)
ERVS_SHORT_MAX = 64
ERVS_SALT = 0x9E3779B9
ERJS_SALT = 0x00C0FFEE
ITS_SALT = 0x175CDF
ALIAS_SALT = 0xA11A5
TOKEN_SALT = 0x700C0DE
# weights per gathered [n, width] block of the plain eRVS version
_CHUNK_ELEMS = 1 << 25


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


# ------------------------------------------------ XLA's float32 math
_FLT_MIN = 1.1754943508222875e-38
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022,
          0.008333452045917511, 0.04166579619050026, 0.1666666567325592)
_SQRT_HALF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, -0.12420140951871872,
          0.14249323308467865, 0.2000071406364441, -0.24999994039535522,
          0.11676998436450958, -0.16668057441711426, 0.3333333134651184)


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add rounds
    it; ``a``, ``b``, ``c`` are float32 tensors or Python floats holding
    float32 values, at least one of them a tensor.

    The product is exact in float64.  The float64 sum is rounded to odd:
    where it was inexact and its last bit is even, it moves one float64
    ulp towards the exact sum (the error comes from Knuth's TwoSum).  A
    float64 has more than two bits beyond a float32's, so rounding that
    to float32 gives the correctly rounded result, ties included; the
    plain float64 sum would round twice and part from an FMA where it
    lands on a float32 tie."""
    d = lambda x: x.to(torch.float64) if isinstance(x, torch.Tensor) else x
    p, c = d(a) * d(b), d(c)
    s = p + c
    cc = s - p
    err = (p - (s - cc)) + (c - cc)
    bits = s.view(torch.int64)
    fix = (err != 0) & (bits & 1 == 0) & torch.isfinite(s)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where(fix, (bits + step).view(torch.float64), s)
    return s.to(torch.float32)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as XLA evaluates it on the CPU (finite inputs)."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(fma32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma32(-_LN2_LO, fx, fma32(-_LN2_HI, fx, x))
    y = fma32(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:] + (0.5,):
        y = fma32(y, r, c)
    y = fma32(y, r * r, r) + 1.0
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as XLA evaluates it on the CPU, with subnormal
    inputs read as zero."""
    bits = x.clamp_min(_FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)  # 0x807FFFFF
    small = m < _SQRT_HALF
    e = e - small.to(torch.float32)
    v = (m - 1.0) + torch.where(small, m, 0.0)
    v2 = v * v
    v3 = v2 * v
    p = _LOG_P
    y = fma32(fma32(v, p[0], p[1]), v, p[6])
    y1 = fma32(fma32(v, p[2], p[3]), v, p[7])
    y2 = fma32(fma32(v, p[4], p[5]), v, p[8])
    y = fma32(fma32(y, v3, y1), v3, y2)
    y = fma32(y, v3, e * _LN2_LO)
    v = fma32(-0.5, v2, v) + y
    out = fma32(_LN2_HI, e, v)
    zero = x.abs() < _FLT_MIN
    out = torch.where(x > 0, out, float("nan"))
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where(zero, float("-inf"), out)


# ------------------------------------------------------------ XLA orders
def xla_sum(w: torch.Tensor) -> torch.Tensor:
    """Row sums of ``w`` [n, m] (m a multiple of 32) in XLA's CPU order:
    sequential sums of 32-weight windows, then of the window sums."""
    n, m = w.shape
    win = w.reshape(n, m // 32, 32)
    part = win[:, :, 0]
    for j in range(1, 32):
        part = part + win[:, :, j]
    total = part[:, 0]
    for k in range(1, m // 32):
        total = total + part[:, k]
    return total


def xla_tree_sum(w: torch.Tensor) -> torch.Tensor:
    """Row sums of ``w`` [n, m] in XLA's CPU order for a width m that is a
    power of two (the engine's ``pad``; XLA orders other widths
    otherwise): a row of at most 32 weights is summed sequentially; a
    longer one is cut into 32-weight windows, each summed sequentially,
    and the window sums are summed the same way, level by level.  Equals
    :func:`xla_sum` up to 1024 weights; zeros at a row's end change no
    level's sums, so a shorter row may stand for its zero-padded one."""
    n, m = w.shape
    if m <= 32:
        total = w[:, 0]
        for j in range(1, m):
            total = total + w[:, j]
        return total
    pad = -m % 32
    if pad:
        w = torch.cat([w, w.new_zeros(n, pad)], dim=1)
    win = w.reshape(n, -1, 32)
    part = win[:, :, 0]
    for j in range(1, 32):
        part = part + win[:, :, j]
    return xla_tree_sum(part)


def xla_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive row prefix sums of ``w`` [n, m] in XLA's CPU order: the
    recursive scan with base 16 (m a multiple of 16 whose chunk counts
    divide by 16 at every level above 16)."""
    n, m = w.shape
    if m <= 16:
        out = torch.empty_like(w)
        acc = w[:, 0]
        out[:, 0] = acc
        for j in range(1, m):
            acc = acc + w[:, j]
            out[:, j] = acc
        return out
    chunks = w.reshape(n, m // 16, 16)
    inner = torch.empty_like(chunks)
    acc = chunks[:, :, 0]
    inner[:, :, 0] = acc
    for j in range(1, 16):
        acc = acc + chunks[:, :, j]
        inner[:, :, j] = acc
    tots = xla_cumsum(inner[:, :, 15].contiguous())
    excl = torch.cat([torch.zeros_like(tots[:, :1]), tots[:, :-1]], dim=1)
    return (inner + excl[:, :, None]).reshape(n, m)


def _width(valid: torch.Tensor) -> torch.Tensor:
    """Gathered width of a tile with ``valid`` weights: a multiple of 32 up
    to 256, else of 256.  Weights past ``valid`` are zeros, which change
    neither the sum nor the prefixes in front of them in either order."""
    small = (valid + 31) // 32 * 32
    big = (valid + 255) // 256 * 256
    return torch.where(valid <= 256, small, big).clamp(32, TILE)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float32 ulps of ``b``, in float64."""
    b32 = b.to(torch.float32)
    ulp = (torch.nextafter(b32.abs(), _f32(float("inf"), b.device))
           - b32.abs()).to(torch.float64)
    return (a.to(torch.float64) - b.to(torch.float64)).abs() / ulp


# ----------------------------------------------------------------- eRVS
def ervs_select_ref(w2d: torch.Tensor, row0: torch.Tensor,
                    degs: torch.Tensor, seeds: torch.Tensor,
                    margins: bool = False):
    """Block-jump A-ExpJ reservoir selection: the plain version of K6.

    w2d [R, 128] float32, row0/degs [W] int32, seeds [W, 2] int64 holding
    uint32.  Returns (offset [W] int32 within the row or -1, draws [W]
    int32 — Threefry calls made, jumped [W] int32 — tiles retired by their
    sum alone).  With ``margins=True`` a fourth [W] float64 tensor holds,
    per walker, the least distance in float32 ulps between a decision's
    two sides: a crossing's target and any prefix of a positive weight,
    and the tile sum (less the crossing's base) against the threshold.
    """
    dev = w2d.device
    W = row0.shape[0]
    flat = w2d.reshape(-1)
    deg = degs.to(torch.int64)
    r0 = row0.to(torch.int64) * LANES
    k0, k1 = seeds[:, 0], seeds[:, 1]
    n_tiles = torch.div(deg + TILE - 1, TILE, rounding_mode="floor")
    best_lk = torch.full((W,), float("-inf"), dtype=torch.float32, device=dev)
    best_off = torch.full((W,), -1, dtype=torch.int64, device=dev)
    t_rem = torch.zeros(W, dtype=torch.float32, device=dev)
    draws = torch.zeros(W, dtype=torch.int64, device=dev)
    jumped = torch.zeros(W, dtype=torch.int64, device=dev)
    margin = torch.full((W,), float("inf"), dtype=torch.float64, device=dev)
    st = (best_lk, best_off, t_rem, draws, jumped, margin)
    n_t = int(n_tiles.max()) if W else 0
    for t in range(n_t):
        act = (n_tiles > t).nonzero().squeeze(1)
        valid = (deg[act] - t * TILE).clamp(max=TILE)
        width = _width(valid)
        for m in torch.unique(width).tolist():
            sel = act[width == m]
            step = max(1, _CHUNK_ELEMS // m)
            for c in range(0, sel.numel(), step):
                _ervs_tile(flat, r0, deg, k0, k1, st, sel[c:c + step], t, m,
                           margins)
    out = (best_off.to(torch.int32), draws.to(torch.int32),
           jumped.to(torch.int32))
    return out + (margin,) if margins else out


def _ervs_tile(flat, r0, deg, k0, k1, st, idx, t: int, m: int,
               margins: bool) -> None:
    """Tile ``t`` of walkers ``idx`` (gathered ``m`` wide): the sum, the
    jump or the crossing loop; updates the state tensors ``st`` in place."""
    best_lk, best_off, t_rem, draws, jumped, margin = st
    dev = flat.device
    cols = torch.arange(m, device=dev)
    ok = cols[None, :] < (deg[idx] - t * TILE)[:, None]
    rows = (torch.div(r0[idx], LANES, rounding_mode="floor")
            + t * SUBLANES)[:, None] + torch.div(cols, LANES,
                                                 rounding_mode="floor")
    pos = rows.clamp(0, flat.numel() // LANES - 1) * LANES + cols % LANES
    w = torch.where(ok, flat[pos], _f32(0.0, dev))
    blocksum = xla_sum(w)
    tr = t_rem[idx]
    if margins:  # a zero sum never crosses, whatever the threshold
        margin[idx] = torch.where(blocksum > 0, torch.minimum(
            margin[idx], _ulps(blocksum, tr)), margin[idx])
    crossing = (blocksum >= tr) & (blocksum > 0)
    skip = ~crossing
    t_rem[idx[skip]] = tr[skip] - blocksum[skip]
    jumped[idx[skip]] += 1
    ci = crossing.nonzero().squeeze(1)
    if not ci.numel():
        return
    g = idx[ci]  # walker ids of the crossing lanes
    w, bsum = w[ci], blocksum[ci]
    cum = xla_cumsum(w)
    base = torch.zeros_like(bsum)
    lk, boff, tr = best_lk[g], best_off[g], t_rem[g]
    dr = draws[g]
    neg_inf = _f32(float("-inf"), dev)
    lo80, zero, one = _f32(-80.0, dev), _f32(0.0, dev), _f32(1.0, dev)
    tiny_u, tiny_w, neg_tiny = (_f32(1e-38, dev), _f32(1e-30, dev),
                                _f32(-1e-30, dev))
    while True:
        go = bsum - base >= tr
        if margins:
            margin[g] = torch.minimum(margin[g], _ulps(bsum - base, tr))
        j = go.nonzero().squeeze(1)
        if not j.numel():
            break
        target = base[j] + tr[j]
        wj, cj = w[j], cum[j]
        hit = (cj >= target[:, None]) & (wj > 0)
        first = torch.where(hit, torch.arange(m, device=dev), m).amin(dim=1)
        p = torch.where(first < m, first, 0)
        if margins:
            d = torch.where(wj > 0, _ulps(cj, target[:, None].expand_as(cj)),
                            float("inf")).amin(dim=1)
            margin[g[j]] = torch.minimum(margin[g[j]], d)
        rows = torch.arange(j.numel(), device=dev)
        w_m, c_m = wj[rows, p], cj[rows, p]
        u1, u2 = uniform_pair_01(k0[g[j]], k1[g[j]], dr[j], ERVS_SALT)
        blk = lk[j]
        t_w = xla_exp(torch.minimum(torch.maximum(w_m * blk, lo80), zero))
        uu = torch.where(blk == neg_inf, u1, fma32(u1, one - t_w, t_w))
        lk_new = xla_log(torch.minimum(torch.maximum(uu, tiny_u), one)) \
            / torch.maximum(w_m, tiny_w)
        lk[j] = lk_new
        boff[j] = t * TILE + p
        tr[j] = xla_log(u2) / torch.minimum(lk_new, neg_tiny)
        dr[j] += 1
        base[j] = c_m
    best_lk[g], best_off[g], draws[g] = lk, boff, dr
    t_rem[g] = tr - (bsum - base)


def ervs_leaders_ref(row0: torch.Tensor, degs: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """The walkers that lead K6's table jobs (the plain version of its
    plan): among walkers whose rows hold more than ``ERVS_SHORT_MAX``
    weights,
    the largest walker index on each clipped row slot, and every walker
    whose (row0, deg) differs from its slot's leader's.  Returns their
    indices [J] int64, ascending."""
    n = row0.shape[0]
    ids = torch.arange(n, device=row0.device)
    tabled = (degs > ERVS_SHORT_MAX).nonzero().squeeze(1)
    slot = row0.to(torch.int64)[tabled].clamp(0, rows - 1)
    lead = torch.full((rows,), -1, dtype=torch.int64, device=row0.device)
    lead = lead.scatter_reduce(0, slot, ids[tabled], "amax")[slot]
    own = (lead == tabled) | (row0[lead] != row0[tabled]) \
        | (degs[lead] != degs[tabled])
    return tabled[own]


def _ranges(starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Concatenated ``arange(s, s + l)`` for each (s, l), int64."""
    lens = lens.to(torch.int64)
    offs = torch.cumsum(lens, 0) - lens
    total = int(lens.sum())
    return torch.arange(total, device=starts.device) + torch.repeat_interleave(
        starts.to(torch.int64) - offs, lens, output_size=total)


def ervs_tile_tables_ref(w2d: torch.Tensor, row0: torch.Tensor,
                         degs: torch.Tensor):
    """The tables K6's table pass builds for rows (``row0``, ``degs``)
    [J], concatenated in row order: per tile of each row (its tiles in
    order) the sum in XLA's order (float32) and ``first``, the first
    position of a positive weight whose prefix sum is a number (int32, -1
    without); per row ``roundup32(deg)`` entries of M (float32), tile by
    tile: M[p] is the largest prefix sum (base-16 order) of such a
    position q <= p, -inf before ``first``, and stays flat past the valid
    count.  M is non-decreasing where the prefix sums are not; at a
    crossing, the first p with M[p] >= target is the first positive
    weight whose prefix sum reaches the target, and M[p] is that prefix."""
    dev = w2d.device
    flat = w2d.reshape(-1)
    R = flat.numel() // LANES
    deg = degs.to(torch.int64).clamp_min(0)
    nt = torch.div(deg + TILE - 1, TILE, rounding_mode="floor")
    tile_of = _ranges(torch.zeros_like(nt), nt)  # t within its row
    row_of = torch.repeat_interleave(torch.arange(deg.numel(), device=dev),
                                     nt)
    valid = (deg[row_of] - tile_of * TILE).clamp(max=TILE)
    start = row0.to(torch.int64)[row_of] + tile_of * SUBLANES
    cols = torch.arange(TILE, device=dev)
    sums, firsts, ms = [], [], []
    step = max(1, _CHUNK_ELEMS // TILE)
    for c in range(0, valid.numel(), step):
        v, s0 = valid[c:c + step, None], start[c:c + step, None]
        rows = (s0 + torch.div(cols, LANES, rounding_mode="floor")).clamp(
            0, R - 1)
        w = torch.where(cols < v, flat[rows * LANES + cols % LANES],
                        _f32(0.0, dev))
        cs = xla_cumsum(w)
        counted = (w > 0) & ~torch.isnan(cs)
        has = counted.any(dim=1)
        first = torch.where(has, counted.to(torch.int8).argmax(dim=1), -1)
        m = torch.where(counted, cs, float("-inf")).cummax(dim=1).values
        sums.append(xla_sum(w))
        firsts.append(first.to(torch.int32))
        ms.append(m[cols < (v + 31) // 32 * 32])
    cat = lambda xs, dtype: torch.cat(xs) if xs else torch.empty(
        0, dtype=dtype, device=dev)
    return (cat(sums, torch.float32), cat(firsts, torch.int32),
            cat(ms, torch.float32))


def ervs_select_semantic(w2d: torch.Tensor, row0: torch.Tensor,
                         degs: torch.Tensor, generator: torch.Generator,
                         max_deg: int) -> torch.Tensor:
    """Textbook Efraimidis–Spirakis (a key ln(u)/w per item, argmax) with
    ``generator``: the distribution oracle of the eRVS selections."""
    dev = w2d.device
    flat = w2d.reshape(-1)
    idx = torch.arange(max_deg, device=dev)
    valid = idx[None, :] < degs.to(torch.int64)[:, None]
    pos = (row0.to(torch.int64) * LANES)[:, None] + idx[None, :]
    w = torch.where(valid, flat[pos.clamp(0, flat.numel() - 1)],
                    _f32(0.0, dev))
    u = torch.rand(w.shape, generator=generator, device=dev).clamp_min(1e-12)
    lk = torch.where(w > 0, torch.log(u) / torch.where(w > 0, w, 1.0),
                     float("-inf"))
    best = lk.argmax(dim=1)
    has = lk.amax(dim=1) > float("-inf")
    return torch.where(has, best, -1).to(torch.int32)


# ----------------------------------------------------------------- eRJS
def erjs_select_ref(w2d: torch.Tensor, row0: torch.Tensor,
                    degs: torch.Tensor, bounds: torch.Tensor,
                    seeds: torch.Tensor, trials: int = 8,
                    max_rounds: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bound-based rejection: the plain version of K7.  Trial t draws
    ``uniform_pair_01(seed, (t, ERJS_SALT))``, proposes offset
    ``min(int(u_idx * deg), deg - 1)`` and accepts iff ``u_acc * bound <=
    w`` and ``w > 0``; it stops at acceptance or after ``trials *
    max_rounds`` trials.  Returns (offset [W] int32 or -1, trials [W]
    int32)."""
    dev = w2d.device
    W = row0.shape[0]
    flat = w2d.reshape(-1)
    deg = degs.to(torch.int64)
    off = torch.full((W,), -1, dtype=torch.int64, device=dev)
    used = torch.zeros(W, dtype=torch.int64, device=dev)
    live = ((deg > 0) & (bounds > 0)).nonzero().squeeze(1)
    for t in range(trials * max_rounds):
        if not live.numel():
            break
        cand, at, u_acc = _erjs_trial(w2d, row0, deg, seeds, live, t)
        w = flat[at]
        ok = (u_acc * bounds[live] <= w) & (w > 0)
        used[live] = t + 1
        off[live[ok]] = cand[ok]
        live = live[~ok]
    return off.to(torch.int32), used.to(torch.int32)


def _erjs_trial(w2d, row0, deg, seeds, live, t: int):
    """Trial ``t`` of the walkers ``live``: (candidate offset, the flat
    stream index of its weight, u_acc)."""
    d = deg[live]
    u_idx, u_acc = uniform_pair_01(seeds[live, 0], seeds[live, 1], t,
                                   ERJS_SALT)
    cand = torch.minimum((u_idx * d.to(torch.float32)).to(torch.int64), d - 1)
    rows = row0[live].to(torch.int64) + torch.div(cand, LANES,
                                                  rounding_mode="floor")
    at = rows.clamp(0, w2d.shape[0] - 1) * LANES + cand % LANES
    return cand, at, u_acc


def erjs_reads_ref(w2d: torch.Tensor, row0: torch.Tensor,
                   degs: torch.Tensor, seeds: torch.Tensor,
                   used: torch.Tensor) -> torch.Tensor:
    """The flat stream indices of the weights K7's trials read: trial t <
    ``used[i]`` of walker i (``used`` as ``erjs_select_ref`` returns it)
    reads its candidate's weight.  Returns [sum(used)] int64, trial by
    trial (what a bound counts K7's random reads from)."""
    deg = degs.to(torch.int64)
    out = [torch.empty(0, dtype=torch.int64, device=w2d.device)]
    for t in range(int(used.max()) if used.numel() else 0):
        live = (used > t).nonzero().squeeze(1)
        out.append(_erjs_trial(w2d, row0, deg, seeds, live, t)[1])
    return torch.cat(out)


# ---------------------------------------------------- precomputed tables
def _its_search(flat: torch.Tensor, start: torch.Tensor, deg: torch.Tensor,
                target: torch.Tensor, probes=None) -> torch.Tensor:
    """The lower-bound binary search of the rows ``[start, start + deg)``
    of ``flat`` for ``target``: each level probes ``mid = (lo + hi) // 2``
    (its flat index clipped to the stream) and goes right iff the entry is
    at most the target.  Returns lo [n] int64; appends each level's probed
    indices of the walkers still searching to ``probes`` when given."""
    lo = torch.zeros_like(deg)
    hi = deg.clone()
    for _ in range(32):
        live = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        at = (start + mid).clamp(0, flat.numel() - 1)
        if probes is not None:
            probes.append(at[live])
        right = (flat[at] <= target) & live
        lo, hi = torch.where(right, mid + 1, lo), \
            torch.where(live & ~right, mid, hi)
    return lo


def its_search_ref(cdf2d: torch.Tensor, row0: torch.Tensor,
                   degs: torch.Tensor, totals: torch.Tensor,
                   seeds: torch.Tensor) -> torch.Tensor:
    """CDF binary search on the aligned stream: the plain version of K3's
    aligned entry.  u = uniform_01(seed, (0, ITS_SALT)), target u·total,
    the first offset whose inclusive prefix exceeds it; -1 for empty or
    zero-total rows.  Returns [W] int32."""
    deg = degs.to(torch.int64)
    u = uniform_01(seeds[:, 0], seeds[:, 1], 0, ITS_SALT)
    lo = _its_search(cdf2d.reshape(-1), row0.to(torch.int64) * LANES, deg,
                     u * totals)
    sel = torch.minimum(lo, (deg - 1).clamp_min(0))
    return torch.where((deg > 0) & (totals > 0), sel, -1).to(torch.int32)


def its_reads_ref(cdf2d: torch.Tensor, row0: torch.Tensor,
                  degs: torch.Tensor, totals: torch.Tensor,
                  seeds: torch.Tensor) -> torch.Tensor:
    """The flat stream indices that :func:`its_search_ref`'s binary search
    reads, clipped to the stream as it reads them, for the walkers whose
    draw depends on them (degree and total above 0; the others draw -1
    whatever the stream holds).  Returns [probes] int64, level by level
    (what a bound counts K3's aligned reads from)."""
    draw = ((degs > 0) & (totals > 0)).nonzero().squeeze(1)
    u = uniform_01(seeds[draw, 0], seeds[draw, 1], 0, ITS_SALT)
    probes = [torch.empty(0, dtype=torch.int64, device=cdf2d.device)]
    _its_search(cdf2d.reshape(-1), row0[draw].to(torch.int64) * LANES,
                degs[draw].to(torch.int64), u * totals[draw], probes)
    return torch.cat(probes)


def _alias_column(flat_p: torch.Tensor, row0: torch.Tensor,
                  degs: torch.Tensor, seeds: torch.Tensor):
    """(the column's clipped flat index, the column, u2) of each walker's
    alias draw: (u1, u2) = uniform_pair_01(seed, (0, ALIAS_SALT)), column
    min(int(u1 · deg), deg - 1)."""
    deg = degs.to(torch.int64)
    u1, u2 = uniform_pair_01(seeds[:, 0], seeds[:, 1], 0, ALIAS_SALT)
    col = torch.minimum((u1 * deg.to(torch.float32)).to(torch.int64),
                        (deg - 1).clamp_min(0))
    pos = (row0.to(torch.int64) * LANES + col).clamp(0, flat_p.numel() - 1)
    return pos, col, u2


def alias_pick_ref(prob2d: torch.Tensor, alias2d: torch.Tensor,
                   row0: torch.Tensor, degs: torch.Tensor,
                   totals: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Alias accept-or-alias on the aligned streams (alias offsets ride
    the float32 stream): the plain version of K5's aligned entry.
    Returns [W] int32, -1 for empty or zero-total rows."""
    flat_p, flat_a = prob2d.reshape(-1), alias2d.reshape(-1)
    pos, col, u2 = _alias_column(flat_p, row0, degs, seeds)
    sel = torch.where(u2 < flat_p[pos], col, flat_a[pos].to(torch.int64))
    return torch.where((degs > 0) & (totals > 0), sel, -1).to(torch.int32)


def alias_reads_ref(prob2d: torch.Tensor, row0: torch.Tensor,
                    degs: torch.Tensor, totals: torch.Tensor,
                    seeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat stream indices that :func:`alias_pick_ref` reads, for the
    walkers whose draw depends on them (degree and total above 0): (each
    one's column in ``prob2d``, the column in the alias stream of those
    that reject it, u2 not below its keep probability).  Both int64, in
    walker order (what a bound counts K5's aligned reads from)."""
    flat_p = prob2d.reshape(-1)
    draw = ((degs > 0) & (totals > 0)).nonzero().squeeze(1)
    pos, _, u2 = _alias_column(flat_p, row0[draw], degs[draw], seeds[draw])
    return pos, pos[~(u2 < flat_p[pos])]


# --------------------------------------------------------- token sampler
def token_sample_ref(logits: torch.Tensor, seed: torch.Tensor,
                     temperature: float = 1.0,
                     greedy: bool = False) -> torch.Tensor:
    """Gumbel-max categorical sampling over the vocab: the plain version
    of K8.  logits [B, V] float32, seed [2] int64 holding uint32.  Returns
    token ids [B] int32: the first index of the largest key per row.

    Key of token v in row b: ``logit * (1/T) + g`` with ``g = -ln(-ln
    u)``, ``u = uniform_01(seed0 + b mod 2^32, seed1, v, TOKEN_SALT)``, as
    XLA on the CPU compiles the reference: the multiply and the add are
    one fused multiply-add (:func:`fma32`), the logs are :func:`xla_log`,
    and ``1/T`` is ``float32(1.0 / T)`` rounded from the double.  Greedy
    takes the logits as the keys.
    """
    if greedy:
        return torch.argmax(logits, dim=1).to(torch.int32)
    B, V = logits.shape
    dev = logits.device
    row = torch.arange(B, dtype=torch.int64, device=dev)
    ctr = torch.arange(V, dtype=torch.int64, device=dev)
    k0 = ((seed[0] + row) & MASK32)[:, None]
    u = uniform_01(k0, seed[1], ctr[None, :], TOKEN_SALT)
    g = -xla_log(-xla_log(u))
    inv_t = float(np.float32(1.0 / temperature))
    keys = fma32(logits, inv_t, g)
    return torch.argmax(keys, dim=1).to(torch.int32)
