"""eRJS — enhanced rejection sampling (port of ``repro/core/erjs.py``;
paper §3.3): the plain PyTorch version of kernel K2.

Each walker proposes X ~ Uniform(N(v)) and accepts iff u·c ≤ w̃(X) with c
the compiler's upper bound of w̃ (Eqs. 5–8), for up to ``max_rounds``
rounds of ``trials_per_round`` trials; walkers still unresolved fall back
to the reservoir side (§7.1).  Trial k of round r draws its offset from
counter ``r·2K + 2k`` and its acceptance uniform from ``r·2K + 2k + 1``.
A walker's result never depends on the other walkers, so this batch loop
and the kernel's per-walker loop agree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.ctxutil import degrees_of, single_edge_ctx
from repro_torch.core.types import WalkProgram
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels.prng import fold_in, uniform


def erjs_step(graph: CSRGraph, program: WalkProgram, params, cur, prev, step,
              keys: torch.Tensor, bound: torch.Tensor,
              trials_per_round: int = 8, max_rounds: int = 16,
              active: Optional[torch.Tensor] = None, wstate=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (next [W] int64, needs_fallback [W] bool, trials [W] int32)
    for walkers with program state ``wstate``.

    next = -2 for inactive walkers, -1 for zero-degree rows and for
    walkers left to the fallback; ``trials`` counts each walker's
    proposals."""
    W = cur.shape[0]
    K = trials_per_round
    if active is None:
        active = torch.ones(W, dtype=torch.bool, device=cur.device)
    deg = degrees_of(graph, cur)
    feasible = active & (deg > 0) & (bound > 0)
    done = ~feasible
    chosen = torch.full((W,), -1, dtype=torch.int64, device=cur.device)
    trials = torch.zeros(W, dtype=torch.int32, device=cur.device)
    degf = deg.to(torch.float32)
    for r in range(max_rounds):
        if not bool((feasible & ~done).any()):
            break
        # the round's 2K uniforms at once: [W, 2K], counter r·2K + column
        ctr = torch.arange(r * 2 * K, (r + 1) * 2 * K, device=cur.device)
        u = uniform(fold_in(keys[:, None, :], ctr[None, :]))
        for k in range(K):
            u_idx, u_acc = u[:, 2 * k], u[:, 2 * k + 1]
            offset = torch.minimum((u_idx * degf).to(torch.int64),
                                   (deg - 1).clamp_min(0))
            ctx, valid = single_edge_ctx(graph, program, cur, prev, step,
                                         offset)
            w = torch.where(valid, torch.clamp_min(
                program.edge_weight(ctx, params, wstate), 0.0), 0.0)
            pending = feasible & ~done
            accept = pending & (u_acc * bound <= w) & (w > 0)
            trials += pending.to(torch.int32)
            chosen = torch.where(accept, ctx.nbr, chosen)
            done = done | accept
    needs_fallback = feasible & ~done
    return torch.where(active, chosen, -2), needs_fallback, trials
