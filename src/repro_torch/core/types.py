"""Shared types of the port: edge contexts, walk programs, walker state
(port of ``repro/core/types.py``).

A :class:`WalkProgram`'s ``get_weight(ctx, params, wstate)`` evaluates
the transition weight w̃ of a whole block of candidate edges at once:
every :class:`EdgeCtx` field is a tensor of the block's shape.  The
Flexi-Compiler (``core/flexi_compiler.py``) traces it to derive its bound,
Eq. 12 sum and taint, and ``kernels/rulegen.py`` builds it into the CUDA
kernels as generated device code.  A program may still name a
hand-written device rule (``kernel_rule``), which the kernels then run
instead, and declare its bound, sum and read fields, which only the tests
read (as the oracle the analysis is held against).

Per-walker program state (``wstate``) is a tuple of tensors whose dim 0
is the walker, the torch form of the reference's pytree leaves (or None
for a stateless program).  The hooks take and return whole batches:
``init_walker_state(query_ids [n])`` gives n walkers' state, ``on_step``
and ``should_stop`` see the [W] transition ctx and the [W]-leading state.
"""
from __future__ import annotations

import dataclasses
import warnings
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


EDGE_FIELDS = ("h", "label", "dist", "nbr")
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

    Declarations, read by the tests only (the engine analyses the traced
    weight):

    ``reads``       EdgeCtx fields the weight's value depends on (the taint
                    set the compiler computes); None = not declared.
    ``bound``       ``bound(bi, params) -> [W]`` upper bound of w̃ over a
                    walker's row, bitwise the compiler's ``bound_fn``.
    ``weight_sum``  ``weight_sum(bi, params) -> [W]`` Eq. 12 estimate of
                    Σ w̃, bitwise the compiler's ``sum_fn``.

    ``kernel_rule`` ``kernel_rule(params) -> KernelRule``: a hand-written
                    device rule the CUDA kernels evaluate in place of the
                    generated one (None: the weight is generated code).

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
    reads: Optional[FrozenSet[str]] = None
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

    def edge_weight(self, ctx: EdgeCtx, params, wstate) -> torch.Tensor:
        """The one indirection every weight evaluation goes through (the
        engine, the compiler's trace): the legacy :class:`Workload`
        overrides it to drop ``wstate``."""
        return self.get_weight(ctx, params, wstate)

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


@dataclasses.dataclass(frozen=True)
class Workload(WalkProgram):
    """DEPRECATED: the original bare protocol (``get_weight(ctx, params)``
    and flags).  Still constructible, and adapts into the
    :class:`WalkProgram` contract with the same paths and telemetry: its
    weight traces to the same graph.  New code constructs
    :class:`WalkProgram` directly."""

    def __post_init__(self):
        warnings.warn(
            "Workload is deprecated; define a WalkProgram instead "
            "(get_weight takes (ctx, params, wstate), and per-walker "
            "state / on_step / should_stop become available)",
            DeprecationWarning, stacklevel=3)

    def edge_weight(self, ctx: EdgeCtx, params, wstate) -> torch.Tensor:
        return self.get_weight(ctx, params)  # the legacy two-argument rule


def from_workload(workload) -> WalkProgram:
    """Any legacy workload object (a :class:`Workload`, or anything with
    its attributes) as a :class:`WalkProgram` whose ``get_weight`` drops
    the (empty) ``wstate``: the same traced graph, so the same analysis
    and paths.  A program already speaking the new protocol is returned
    as it is."""
    if isinstance(workload, WalkProgram) and not isinstance(workload,
                                                            Workload):
        return workload
    legacy_gw = workload.get_weight
    return WalkProgram(
        name=workload.name, init=workload.init,
        get_weight=lambda ctx, params, wstate: legacy_gw(ctx, params),
        needs_dist=workload.needs_dist, needs_labels=workload.needs_labels,
        num_labels=workload.num_labels, weighted=workload.weighted,
        walk_len=workload.walk_len)


@dataclasses.dataclass
class WalkerState:
    """State of W walker slots (every field's dim 0 is the slot).

    A lane is live for a step iff ``alive ∧ degree(cur) > 0 ∧ step <
    num_steps``; every other field of a dead or empty lane is residue the
    live mask hides.  ``rng`` holds the raw key data of each slot's
    per-query stream ``fold_in(key, query_id)``; the per-step key folds in
    ``step`` (:meth:`stream_keys`), so a query's draws do not depend on its
    slot or epoch.

    ``carry`` is sampler-owned cross-step state (the ``interleaved``
    sampler's prefetched neighbour tile, ``samplers.PrefetchTile``), None
    for samplers that carry nothing:

    * it never changes a lane's distribution, only where the sampler
      reads its data from;
    * refills do not reset it (unlike ``wstate``): a sampler validates it
      per lane (the prefetch tile records the node it was gathered for,
      and a lane now elsewhere reads the graph);
    * every leaf keeps the slot dimension first.
    """

    cur: torch.Tensor  # [W] int64 current node
    prev: torch.Tensor  # [W] int64 previous node (-1 before the first step)
    step: torch.Tensor  # [W] int64 steps taken by the current occupant
    alive: torch.Tensor  # [W] bool
    rng: torch.Tensor  # [W, 2] int64 raw per-query key data (uint32 values)
    #: sampler-owned cross-step state (see above; None: carries nothing)
    carry: Any = None
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
