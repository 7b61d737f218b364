"""Flexi-Compiler facts the port needs (port of the parts of
``repro/core/flexi_compiler.py`` on the main path).

The reference abstract-interprets each weight rule's jaxpr to synthesise
an interval bound (``bound_fn``), an Eq. 12 sum estimate (``sum_fn``) and
the taint set that decides the flag, the static regime and what the fused
epoch may run (:func:`fuse_report`).  The port's ``torch.fx`` interpreter
waits for a later slice: here each program *declares* its bound, its sum
and the fields its weight reads (``WalkProgram.bound`` / ``weight_sum`` /
``reads``), and the tests hold the declarations against the reference's
``bound_fn`` / ``sum_fn`` (bitwise) and ``fuse_report``.  The declared
bounds are written with :class:`Interval` and its operations, which
repeat the reference interpreter's rules (corner products, the
select-by-uncertain-predicate hull) in the same float32 order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.types import (NODE_FIELDS, EdgeCtx, WalkProgram,
                                    WState)

PER_KERNEL = "PER_KERNEL"
PER_STEP = "PER_STEP"
FALLBACK = "FALLBACK"

#: inputs that vary with walk state; a weight that reads none of them is
#: a constant of the graph, so its rows can be baked into ITS tables
STATE_FIELDS = frozenset({"dist", "prev", "deg_prev", "step", "wstate"})


@dataclasses.dataclass(frozen=True)
class BoundInputs:
    """Per-walker runtime values the estimators read ([W] tensors): the
    current node's h statistics and the walker's own state, with the
    program's per-walker ``wstate`` leaves ([W]-leading; None when
    stateless), concrete like ``cur`` / ``prev`` / ``step``."""

    h_min: torch.Tensor
    h_max: torch.Tensor
    h_mean: torch.Tensor
    deg_cur: torch.Tensor
    deg_prev: torch.Tensor
    cur: torch.Tensor
    prev: torch.Tensor
    step: torch.Tensor
    wstate: WState = None


@dataclasses.dataclass(frozen=True)
class Interval:
    """[lo, hi] of a value over a walker's row, one entry per walker;
    ``exact`` when lo is hi by construction (the reference's ``IVal``)."""

    lo: torch.Tensor
    hi: torch.Tensor
    exact: bool = False

    @staticmethod
    def point(x: torch.Tensor) -> "Interval":
        return Interval(x, x, True)


def iv_mul(a: Interval, b: Interval) -> Interval:
    """The reference's ``_mul``: exact product, else the corner hull."""
    if a.exact and b.exact:
        return Interval.point(a.lo * b.lo)
    c = (a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi)
    return Interval(torch.minimum(torch.minimum(c[0], c[1]),
                                  torch.minimum(c[2], c[3])),
                    torch.maximum(torch.maximum(c[0], c[1]),
                                  torch.maximum(c[2], c[3])))


def iv_select(certainly: torch.Tensor, possibly: torch.Tensor,
              if_false: Interval, if_true: Interval) -> Interval:
    """The reference's ``_select_n`` of two cases under an uncertain
    predicate (``certainly`` / ``possibly`` true): a known branch where
    the predicate is settled, else the hull of both."""
    lo = torch.minimum(if_false.lo, if_true.lo)
    hi = torch.maximum(if_false.hi, if_true.hi)
    return Interval(
        torch.where(certainly, if_true.lo,
                    torch.where(~possibly, if_false.lo, lo)),
        torch.where(certainly, if_true.hi,
                    torch.where(~possibly, if_false.hi, hi)))


def h_interval(bi: BoundInputs, weighted: bool) -> Interval:
    """h over the row: [h_min, h_max] when weighted, else the point 1."""
    if weighted:
        return Interval(bi.h_min, bi.h_max)
    return Interval.point(torch.ones((), device=bi.h_max.device))


@dataclasses.dataclass
class CompiledWorkload:
    """What the compiler knows about one program.  ``bound_fn`` returns the
    upper bound of w̃ (the reference's ``bound_fn`` hi endpoint)."""

    workload: WalkProgram
    flag: str
    warnings: List[str]
    bound_fn: Optional[Callable[[BoundInputs], torch.Tensor]]
    sum_fn: Optional[Callable[[BoundInputs], torch.Tensor]]

    @property
    def usable(self) -> bool:
        return self.flag != FALLBACK


def analyze(program: WalkProgram) -> CompiledWorkload:
    """Compile a program from its declarations.  Never raises: a program
    without a declared bound and sum gets FALLBACK (eRVS-only mode)."""
    if program.bound is None or program.weight_sum is None:
        return CompiledWorkload(
            program, FALLBACK,
            [f"{program.name}: no declared bound/sum — eRVS-only mode"],
            None, None)
    params = program.params()
    runtime = (set(NODE_FIELDS) | {"wstate"}
               | ({"h"} if program.weighted else set()))
    flag = PER_STEP if program.reads & runtime else PER_KERNEL
    return CompiledWorkload(
        program, flag, [],
        lambda bi: program.bound(bi, params),
        lambda bi: program.weight_sum(bi, params))


def is_static(program: WalkProgram) -> bool:
    """True iff the weight provably ignores the walk state — the gate of
    the precomputed (ITS table) regime."""
    return not (program.reads & STATE_FIELDS)


#: per-edge fields the fused epoch does not build for a candidate edge
#: (it evaluates weights with dist=1, label=0): a weight that reads one of
#: them runs staged
FUSE_EDGE_EXCLUDED = frozenset({"dist", "label"})

#: inputs that are not node-local: a bound that reads one of them cannot
#: be baked into the per-node table the fused rejection regime reads
FUSE_BOUND_STATE = frozenset(
    {"dist", "label", "deg_prev", "prev", "step", "wstate"})


@dataclasses.dataclass(frozen=True)
class FuseReport:
    """Whether a walk program can run in the fused epoch (K4).

    ``weight_fusable``   the weight reads neither ``dist`` nor ``label``;
    ``hooks_fusable``    it has no hooks, or its ``on_step`` keeps the
                         state's leaf shapes and dtypes and its
                         ``should_stop`` gives one flag per walker (whether
                         K4 has the hooks' device form is the fused plan's
                         question, ``megastep.runs_hooks``);
    ``bound_node_local`` its bound depends on node-local inputs only, so
                         the rejection regime can read a baked per-node
                         table.

    ``fusable`` needs the first two; the rejection regime also the third.
    """

    weight_fusable: bool
    hooks_fusable: bool
    bound_node_local: bool
    reasons: Tuple[str, ...] = ()

    @property
    def fusable(self) -> bool:
        return self.weight_fusable and self.hooks_fusable


def fuse_report(program: WalkProgram) -> FuseReport:
    """What the fused epoch may run for ``program``, from its declared
    ``reads`` (the reference derives the same facts from the taint of its
    jaxpr).  Never raises: a miss keeps the staged scan."""
    reasons: List[str] = []
    bad = sorted(program.reads & FUSE_EDGE_EXCLUDED)
    flagged = [f for f, need in (("dist", program.needs_dist),
                                 ("label", program.needs_labels)) if need]
    if bad:
        reasons.append(f"get_weight depends on {', '.join(bad)} — the "
                       f"kernel cannot build these per candidate edge")
    elif flagged:
        reasons.append(f"program requests {', '.join(flagged)} payloads "
                       f"the kernel does not materialise")
    state = sorted(program.reads & FUSE_BOUND_STATE)
    if state:
        reasons.append(f"bound depends on non-node-local inputs {state} — "
                       f"no baked per-node bound; rejection stays staged")
    hooks_fusable = True
    if program.has_hooks:
        try:
            _check_hooks(program)
        except Exception as e:  # noqa: BLE001 — a miss keeps staged
            hooks_fusable = False
            reasons.append(f"hooks not stageable: {e!r}")
    return FuseReport(weight_fusable=not bad and not flagged,
                      hooks_fusable=hooks_fusable,
                      bound_node_local=not state, reasons=tuple(reasons))


def _check_hooks(program: WalkProgram) -> None:
    """Raise unless ``on_step`` maps the state of one walker onto leaves of
    the same shapes and dtypes and ``should_stop`` gives one flag for it
    (the reference's shape checks, on a batch of one)."""
    ws = program.init_wstate_batch(torch.zeros(1, dtype=torch.int64))
    one = lambda x, dtype=torch.int64: torch.full((1,), x, dtype=dtype)
    tctx = EdgeCtx(h=one(1.0, torch.float32), label=one(-1), dist=one(-1),
                   nbr=one(0), deg_cur=one(1), deg_prev=one(0), cur=one(0),
                   prev=one(-1), step=one(0))
    if program.on_step is not None:
        out = program.on_step(tctx, program.params(), ws)
        want = [(tuple(x.shape), x.dtype) for x in ws or ()]
        got = [(tuple(x.shape), x.dtype) for x in out or ()]
        if got != want:
            raise TypeError(f"on_step leaves {got} != {want}")
    if program.should_stop is not None:
        stop = program.should_stop(tctx, program.params(), ws)
        if tuple(stop.shape) != (1,):
            raise TypeError(f"should_stop gives shape {tuple(stop.shape)} "
                            f"for one walker, want (1,)")
