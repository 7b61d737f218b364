"""Shared types of the port: edge contexts, walk programs, walker state
(port of ``repro/core/types.py``).

A :class:`WalkProgram`'s ``get_weight(ctx, params)`` evaluates the
transition weight w̃ of a whole block of candidate edges at once: every
:class:`EdgeCtx` field is a tensor of the block's shape.  Because a
hand-written kernel cannot trace a Python rule, a program that runs on
the card also names its device weight rule (``kernel_rule``), and — until
the port's compiler lands — declares the Flexi-Compiler facts the
reference derives from its jaxpr: the fields its weight reads, its bound
and its Eq. 12 sum.

Per-walker program state (``wstate``) is a tuple of tensors whose dim 0
is the walker, the torch form of the reference's pytree leaves (or None
for a stateless program).  The hooks take and return whole batches:
``init_walker_state(query_ids [n])`` gives n walkers' state, ``on_step``
and ``should_stop`` see the [W] transition ctx and the [W]-leading state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, FrozenSet, Optional, Tuple

import torch

from repro_torch.kernels.prng import fold_in


@dataclasses.dataclass(frozen=True)
class EdgeCtx:
    """Context of a block of candidate edges (v_cur → nbr), one tensor per
    field.  Per-edge: h, label, dist, nbr.  Per-node / per-step: deg_cur,
    deg_prev, cur, prev, step (broadcast over the block)."""

    h: torch.Tensor
    label: torch.Tensor
    dist: torch.Tensor
    nbr: torch.Tensor
    deg_cur: torch.Tensor
    deg_prev: torch.Tensor
    cur: torch.Tensor
    prev: torch.Tensor
    step: torch.Tensor


NODE_FIELDS = ("deg_cur", "deg_prev", "cur", "prev", "step")

#: per-walker program state: one tensor per leaf, dim 0 the walker
WState = Optional[Tuple[torch.Tensor, ...]]


def wstate_rows(wstate: WState, idx: torch.Tensor) -> WState:
    """The rows ``idx`` of every leaf (the state of a compacted lane list)."""
    return None if wstate is None else tuple(leaf[idx] for leaf in wstate)


def _stateless(query_ids):
    return None


@dataclasses.dataclass(frozen=True)
class WalkProgram:
    """A walk program: hyperparameters, a batched weight rule, and what the
    engine and the kernels need to know about the rule.

    ``reads``       EdgeCtx fields the weight's value depends on (the taint
                    set the reference's compiler computes).
    ``bound``       ``bound(bi, params) -> [W]`` upper bound of w̃ over a
                    walker's row, bitwise the reference compiler's
                    ``bound_fn`` hi endpoint; None = no bound (eRVS only).
    ``weight_sum``  ``weight_sum(bi, params) -> [W]`` Eq. 12 estimate of
                    Σ w̃, bitwise the reference's ``sum_fn``.
    ``kernel_rule`` ``kernel_rule(params) -> KernelRule``: the device
                    weight function the CUDA kernels evaluate.

    Per-walker state and hooks (the reference's ``WalkProgram`` contract,
    batched):

    ``init_walker_state(query_ids)``  state of the walkers serving
                    ``query_ids`` ([n] int64): a tuple of [n, ...]
                    tensors, or None (stateless);
    ``get_weight(ctx, params, wstate)``  w̃ of a block of edges; leaves
                    lead with the walker dim of ``ctx``, and the rule
                    broadcasts them over the block's other dims;
    ``on_step(tctx, params, wstate) -> wstate``  the transition just
                    taken ([W] ctx: ``nbr`` = node moved to, ``cur`` /
                    ``prev`` / ``step`` the pre-move view, ``h=1``,
                    ``label=-1``, ``dist=-1``); the engine commits it on
                    the lanes that moved;
    ``should_stop(tctx, params, wstate) -> [W] bool``  with the NEW state;
                    True folds into ``alive``;
    ``hook_rule``   ``hook_rule(params) -> HookRule``: the device form of
                    the hooks, which the fused epoch K4 runs.
    """

    name: str
    init: Callable[[], Any]
    get_weight: Callable[..., torch.Tensor]
    init_walker_state: Callable[[torch.Tensor], WState] = _stateless
    on_step: Optional[Callable[[EdgeCtx, Any, WState], WState]] = None
    should_stop: Optional[Callable[[EdgeCtx, Any, WState],
                                   torch.Tensor]] = None
    reads: FrozenSet[str] = frozenset({"h"})
    bound: Optional[Callable[[Any, Any], torch.Tensor]] = None
    weight_sum: Optional[Callable[[Any, Any], torch.Tensor]] = None
    kernel_rule: Optional[Callable[[Any], Any]] = None
    hook_rule: Optional[Callable[[Any], Any]] = None
    needs_dist: bool = False
    needs_labels: bool = False
    num_labels: int = 1
    weighted: bool = True
    walk_len: int = 80

    def params(self):
        return self.init()

    @property
    def has_hooks(self) -> bool:
        """Whether the engine must run the per-step hook machinery."""
        return self.on_step is not None or self.should_stop is not None

    def init_wstate_batch(self, query_ids: torch.Tensor) -> WState:
        """State of the walkers serving ``query_ids`` ([n]-leading leaves)."""
        return self.init_walker_state(query_ids.to(torch.int64))

    def wstate_template(self, device="cpu") -> WState:
        """One walker's initial state (leaves without the walker dim)."""
        ws = self.init_wstate_batch(
            torch.zeros(1, dtype=torch.int64, device=device))
        return None if ws is None else tuple(leaf[0] for leaf in ws)


@dataclasses.dataclass
class WalkerState:
    """State of W walker slots (every field's dim 0 is the slot).

    A lane is live for a step iff ``alive ∧ degree(cur) > 0 ∧ step <
    num_steps``; every other field of a dead or empty lane is residue the
    live mask hides.  ``rng`` holds the raw key data of each slot's
    per-query stream ``fold_in(key, query_id)``; the per-step key folds in
    ``step`` (:meth:`stream_keys`), so a query's draws do not depend on its
    slot or epoch.
    """

    cur: torch.Tensor  # [W] int64 current node
    prev: torch.Tensor  # [W] int64 previous node (-1 before the first step)
    step: torch.Tensor  # [W] int64 steps taken by the current occupant
    alive: torch.Tensor  # [W] bool
    rng: torch.Tensor  # [W, 2] int64 raw per-query key data (uint32 values)
    #: program-owned state (None: stateless); advanced by ``on_step`` on
    #: lanes that moved, reset per query on refill
    wstate: WState = None

    @staticmethod
    def stream_key_data(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Raw key data of the per-query streams ``fold_in(key, id)``."""
        ids = ids.to(torch.int64)
        return fold_in(key.to(ids.device).expand(ids.shape[0], 2), ids)

    @staticmethod
    def create(starts: torch.Tensor, key: torch.Tensor,
               wstate: WState = None) -> "WalkerState":
        """A fully occupied batch: walker i serves query i (stream
        ``fold_in(key, i)``; ``wstate``, when given, its program state)."""
        W, dev = starts.shape[0], starts.device
        ids = torch.arange(W, dtype=torch.int64, device=dev)
        return WalkerState(
            cur=starts.to(torch.int64),
            prev=torch.full((W,), -1, dtype=torch.int64, device=dev),
            step=torch.zeros(W, dtype=torch.int64, device=dev),
            alive=torch.ones(W, dtype=torch.bool, device=dev),
            rng=WalkerState.stream_key_data(key, ids), wstate=wstate)

    def stream_keys(self) -> torch.Tensor:
        """[W, 2] per-step keys: each walker's stream ⊕ its step count."""
        return fold_in(self.rng, self.step)


@dataclasses.dataclass
class StepStats:
    """Telemetry of one step, over live lanes only (int64 scalars)."""

    #: bit positions of the per-(lane, step) flag words the fused epoch
    #: emits (``kernels/megastep.py``); class attributes, not fields
    LIVE, RJS, FALLBACK, PRECOMP, STALE = 0, 1, 2, 3, 4

    live: torch.Tensor
    rjs_served: torch.Tensor
    fallbacks: torch.Tensor
    precomp_served: torch.Tensor
    stale_served: torch.Tensor

    def host_totals(self) -> dict:
        """Each counter summed to a host int, keyed by field name."""
        return {f.name: int(getattr(self, f.name).sum())
                for f in dataclasses.fields(self)}

    @classmethod
    def from_flag_bits(cls, flags: torch.Tensor) -> "StepStats":
        """Per-step counters ([T] int64 each) of a [W, T] int32 flag-word
        matrix: integer sums per bit, so they equal the staged step's
        counts exactly."""
        def count(bit):
            return ((flags >> bit) & 1).sum(dim=0, dtype=torch.int64)

        return cls(live=count(cls.LIVE), rjs_served=count(cls.RJS),
                   fallbacks=count(cls.FALLBACK),
                   precomp_served=count(cls.PRECOMP),
                   stale_served=count(cls.STALE))
