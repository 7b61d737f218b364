"""Flexi-Compiler facts the port needs (port of the parts of
``repro/core/flexi_compiler.py`` on the main path).

The reference abstract-interprets each weight rule's jaxpr to synthesise
an interval bound (``bound_fn``), an Eq. 12 sum estimate (``sum_fn``) and
the taint set that decides the flag, the static regime and what the fused
epoch may run (:func:`fuse_report`).  The port's ``torch.fx`` interpreter
waits for a later slice: here each program *declares* its bound, its sum
and the fields its weight reads (``WalkProgram.bound`` / ``weight_sum`` /
``reads``), and the tests hold the declarations against the reference's
``bound_fn`` / ``sum_fn`` (bitwise) and ``fuse_report``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.types import NODE_FIELDS, WalkProgram

PER_KERNEL = "PER_KERNEL"
PER_STEP = "PER_STEP"
FALLBACK = "FALLBACK"

#: inputs that vary with walk state; a weight that reads none of them is
#: a constant of the graph, so its rows can be baked into ITS tables
STATE_FIELDS = frozenset({"dist", "prev", "deg_prev", "step", "wstate"})


@dataclasses.dataclass(frozen=True)
class BoundInputs:
    """Per-walker runtime values the estimators read ([W] tensors): the
    current node's h statistics and the walker's own state."""

    h_min: torch.Tensor
    h_max: torch.Tensor
    h_mean: torch.Tensor
    deg_cur: torch.Tensor
    deg_prev: torch.Tensor
    cur: torch.Tensor
    prev: torch.Tensor
    step: torch.Tensor


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
    runtime = set(NODE_FIELDS) | ({"h"} if program.weighted else set())
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
    ``hooks_fusable``    its ``on_step`` / ``should_stop`` hooks can run
                         in the kernel (the port's programs have none);
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
    return FuseReport(weight_fusable=not bad and not flagged,
                      hooks_fusable=True, bound_node_local=not state,
                      reasons=tuple(reasons))
