"""The §2.2 baseline samplers (port of ``repro/core/baselines.py``): the
plain PyTorch versions of kernels K9–K12 (``kernels/csrc/baselines.cu``).

Each materialises one [W, pad] block of full-row weights per step, as the
reference does, and reproduces its bits:

* ITS  (C-SAW):       prefix sum, then ``#{prefix <= u * total}``;
* RVS  (FlowWalker):  prefix sum, one uniform per neighbour, the last
  index with ``u_i * W_i < w_i`` wins;
* RJS  (NextDoor):    the exact row maximum, eRJS trials under it, ITS for
  the walkers left unresolved;
* ALS  (Skywalker):   the serial two-stack Vose build of the whole row,
  then a two-uniform draw.

The step functions take the per-step keys [W, 2] where the reference
takes ``rng``.  Sums and prefix sums run in XLA's CPU orders
(``ref.xla_tree_sum``, ``ref.xla_cumsum``), and the uniforms are jax's
(``prng.uniform``): ITS and ALS draw with ``minval=0``, RVS with 1e-12.
No value at a real neighbour depends on ``pad``: the padding adds exact
zeros at the row's end, and a neighbour's uniform depends on its position
alone.  The CUDA kernels therefore scan each walker's own row and never
build the block.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.ctxutil import degrees_of, eval_weights, tile_ctx
from repro_torch.core.erjs import erjs_step
from repro_torch.core.types import WalkProgram
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels.prng import uniform
from repro_torch.kernels.ref import xla_cumsum, xla_tree_sum


def padded_weights(graph: CSRGraph, program: WalkProgram, params, cur, prev,
                   step, pad: int, wstate=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-row transition weights padded to [W, pad]: (w, nbr, mask);
    ``wstate`` is the walkers' program state (None if stateless)."""
    ctx, mask = tile_ctx(graph, program, cur, prev, step, 0, pad)
    return eval_weights(program, params, ctx, mask, wstate), ctx.nbr, mask


def _take(x: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    return x.gather(1, col[:, None])[:, 0]


# ---------------------------------------------------------------- ITS (C-SAW)
def its_step(graph, program, params, cur, prev, step, keys, pad: int,
             wstate=None) -> torch.Tensor:
    """Next node [W] (-1: no positive weight) by inverse transform."""
    w, nbr, _ = padded_weights(graph, program, params, cur, prev, step, pad,
                               wstate)
    csum = xla_cumsum(w)
    total = csum[:, -1]
    r = uniform(keys, minval=0.0) * total
    # the count of prefixes at or below r, as the reference counts them
    # (rounding may dip a prefix by an ulp where a 16-chunk begins)
    sel = (csum <= r[:, None]).sum(dim=1).clamp(max=pad - 1)
    return torch.where(total > 0, _take(nbr, sel), -1)


# ----------------------------------------------------- prefix-RVS (FlowWalker)
def rvs_prefix_step(graph, program, params, cur, prev, step, keys, pad: int,
                    wstate=None) -> torch.Tensor:
    """FlowWalker's parallel reservoir: neighbour i accepts iff
    ``u_i * W_i < w_i`` (W_i the inclusive prefix sum); the last accepting
    neighbour wins."""
    w, nbr, mask = padded_weights(graph, program, params, cur, prev, step,
                                  pad, wstate)
    prefix = xla_cumsum(w)
    u = uniform(keys, pad, minval=1e-12)
    ok = (u * prefix < w) & mask & (w > 0)
    idx = torch.arange(pad, device=w.device)[None, :]
    last = torch.where(ok, idx, -1).max(dim=1).values
    return torch.where(last >= 0, _take(nbr, last.clamp_min(0)), -1)


# ------------------------------------------------------ max-reduce RJS (NextDoor)
def row_max(graph, program, params, cur, prev, step, pad: int,
            wstate=None) -> torch.Tensor:
    """The exact maximum [W] of each padded weight row (the padding's 0
    included): NextDoor's full-row pass."""
    w, _, _ = padded_weights(graph, program, params, cur, prev, step, pad,
                             wstate)
    return w.max(dim=1).values


def rjs_maxreduce_step(graph, program, params, cur, prev, step, keys,
                       pad: int, trials_per_round: int = 8,
                       max_rounds: int = 64, wstate=None) -> torch.Tensor:
    """NextDoor's rejection: the exact row maximum as the bound, eRJS
    trials, and ITS (same keys) for the walkers left unresolved."""
    bound = row_max(graph, program, params, cur, prev, step, pad, wstate)
    nxt, fb, _ = erjs_step(graph, program, params, cur, prev, step, keys,
                           bound, trials_per_round=trials_per_round,
                           max_rounds=max_rounds, wstate=wstate)
    its = its_step(graph, program, params, cur, prev, step, keys, pad,
                   wstate=wstate)
    return torch.where(fb, its, nxt)


# ---------------------------------------------------------------- ALS (Skywalker)
def vose_tables(q: torch.Tensor, valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alias [W, pad] int64, prob [W, pad] float32) of the reference's
    two-stack Vose build over normalised weights ``q``: both stacks hold
    their lanes in ascending order and pop from the top; each iteration
    finalises the top small lane ``s`` against the top large lane ``l``
    (``prob[s] = q[s]``, ``alias[s] = l``, ``q[l] -= 1 - q[s]``) and
    demotes ``l`` to the small stack once ``q[l] < 1``.  The rows run in
    lockstep until at most :data:`VOSE_TAIL_ROWS` still have both stacks
    (a hub row's build is hundreds of thousands of iterations), which
    finish one by one on the host (:func:`_vose_row`); lanes never
    finalised keep prob 1 and themselves as alias."""
    W, pad = q.shape
    dev = q.device
    q = q.clone()
    lane = torch.arange(pad, device=dev)
    small = (q < 1.0) & valid
    large = (q >= 1.0) & valid
    s_stk = torch.where(small, lane, pad).sort(dim=1).values
    l_stk = torch.where(large, lane, pad).sort(dim=1).values
    s_top, l_top = small.sum(dim=1), large.sum(dim=1)
    alias = lane.expand(W, pad).clone()
    prob = torch.ones(W, pad, dtype=torch.float32, device=dev)
    rows = ((s_top > 0) & (l_top > 0)).nonzero().squeeze(1)
    one = torch.ones((), dtype=torch.float32, device=dev)
    while rows.numel() > VOSE_TAIL_ROWS:
        s = s_stk[rows, s_top[rows] - 1]
        l = l_stk[rows, l_top[rows] - 1]
        qs = q[rows, s]
        prob[rows, s] = qs
        alias[rows, s] = l
        new_ql = q[rows, l] - (one - qs)
        q[rows, l] = new_ql
        s_top[rows] -= 1
        demote = new_ql < 1.0
        d = rows[demote]
        l_top[d] -= 1
        s_stk[d, s_top[d]] = l[demote]
        s_top[d] += 1
        rows = rows[(s_top[rows] > 0) & (l_top[rows] > 0)]
    for r in rows.tolist():
        cols, probs, partners = _vose_row(
            q[r].tolist(), s_stk[r, :s_top[r]].tolist(),
            l_stk[r, :l_top[r]].tolist())
        cols = torch.tensor(cols, dtype=torch.int64, device=dev)
        prob[r, cols] = torch.tensor(probs, dtype=torch.float32, device=dev)
        alias[r, cols] = torch.tensor(partners, dtype=torch.int64,
                                      device=dev)
    return alias, prob


#: rows the lockstep Vose build hands to the one-row loop
VOSE_TAIL_ROWS = 4


def _vose_row(q, small, large):
    """The Vose loop of one row on host lists (q: float32 values as
    Python floats; the stacks bottom first): (finalised lanes, their
    prob, their alias).  Each float32 operation is computed in float64
    and rounded once to float32, which is exact for a subtraction of
    float32 values (float64 has more than 2 x 24 + 2 bits)."""
    f32 = np.float32
    cols, probs, partners = [], [], []
    while small and large:
        s, l = small.pop(), large[-1]
        qs = q[s]
        cols.append(s)
        probs.append(qs)
        partners.append(l)
        ql = float(f32(q[l] - float(f32(1.0 - qs))))
        q[l] = ql
        if ql < 1.0:
            large.pop()
            small.append(l)
    return cols, probs, partners


def als_step(graph, program, params, cur, prev, step, keys, pad: int,
             wstate=None) -> torch.Tensor:
    """Alias sampling with the table rebuilt every step: the serial Vose
    build of each walker's row, then a column and a coin."""
    w, nbr, mask = padded_weights(graph, program, params, cur, prev, step,
                                  pad, wstate)
    deg = degrees_of(graph, cur)
    total = xla_tree_sum(w)
    n = deg.clamp_min(1).to(torch.float32)
    floor = torch.tensor(1e-30, dtype=torch.float32, device=w.device)
    q = torch.where(mask, w * n[:, None] / torch.maximum(total, floor)[:, None],
                    1.0)
    alias, prob = vose_tables(q, mask)
    u = uniform(keys, 2, minval=0.0)
    col = torch.minimum((u[:, 0] * deg.to(torch.float32)).to(torch.int64),
                        (deg - 1).clamp_min(0))
    sel = torch.where(u[:, 1] < _take(prob, col), col, _take(alias, col))
    return torch.where(total > 0, _take(nbr, sel), -1)


# Baseline step functions by registry name (samplers.py registers each
# through its wrapper in kernels/baselines.py).
BASELINE_STEP_FNS = {
    "its": its_step,
    "als": als_step,
    "rvs_prefix": rvs_prefix_step,
    "rjs_maxreduce": rjs_maxreduce_step,
}
