"""Flexi-Compiler facts the port needs (port of the parts of
``repro/core/flexi_compiler.py`` on the main path).

The reference abstract-interprets each weight rule's jaxpr to synthesise
an interval bound (``bound_fn``), an Eq. 12 sum estimate (``sum_fn``) and
the taint set that decides the flag and the static regime.  The port's
``torch.fx`` interpreter waits for a later slice: here each program
*declares* its bound, its sum and the fields its weight reads
(``WalkProgram.bound`` / ``weight_sum`` / ``reads``), and the tests hold
the declarations bitwise against the reference's ``bound_fn`` /
``sum_fn`` on the same :class:`BoundInputs`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

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
