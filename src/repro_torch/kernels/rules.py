"""Device weight rules the CUDA kernels evaluate (``csrc/weights.cuh``).

A hand-written kernel cannot trace a Python weight rule, so a program that
runs on the card names one of these rules and its float32 constants.  The
ids must match ``PROGRAM_*`` in ``csrc/weights.cuh``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

DEEPWALK = 0
NODE2VEC = 1


@dataclasses.dataclass(frozen=True)
class KernelRule:
    """``program``: rule id; ``weighted``: whether h enters; ``c0`` / ``c2``:
    Node2Vec's weight factors at dist 0 and dist 2 (1/a and 1/b rounded to
    float32, as the reference's traced constants are)."""

    program: int
    weighted: bool
    c0: float = 1.0
    c2: float = 1.0


def node2vec_rule(a: float, b: float, weighted: bool) -> KernelRule:
    return KernelRule(NODE2VEC, weighted, float(np.float32(1.0 / a)),
                      float(np.float32(1.0 / b)))


def deepwalk_rule(weighted: bool) -> KernelRule:
    return KernelRule(DEEPWALK, weighted)
