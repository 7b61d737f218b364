"""Wrapper of kernel K1 (``csrc/ervs.cu``): per-step eRVS selection.

``ervs_select`` picks the next node of each given walker — exponential
keys (``jump=False``) or the lane-strided A-ExpJ variant (``jump=True``).
On CPU tensors it runs the plain versions ``core.ervs.ervs_step`` /
``ervs_jump_step``; on CUDA tensors it launches the kernel (building it
on first use) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.ervs import ervs_jump_step, ervs_step
from repro_torch.kernels import build
from repro_torch.kernels.rules import DEEPWALK, NODE2VEC, KernelRule


def kernel_rule(program, params) -> KernelRule:
    """The program's device weight rule; raises for programs the kernels do
    not implement."""
    rule = program.kernel_rule(params) if program.kernel_rule else None
    if rule is None or rule.program not in (DEEPWALK, NODE2VEC):
        raise ValueError(f"program {program.name!r} has no device weight "
                         f"rule the CUDA kernels implement")
    return rule


def ervs_select(graph, program, params, cur, prev, step, keys, *,
                tile: int = 256, jump: bool = False) -> torch.Tensor:
    """Next node [n] (int64; -1 when no neighbour has a positive weight) of
    the n walkers at ``cur`` with previous nodes ``prev`` and per-step keys
    ``keys`` [n, 2]."""
    if cur.device.type == "cpu":
        plain = ervs_jump_step if jump else ervs_step
        return plain(graph, program, params, cur, prev, step, keys,
                     tile=tile)
    rule = kernel_rule(program, params)
    n = cur.shape[0]
    dev = cur.device
    build.require_graph(graph, dev)
    build.require(cur, "cur", torch.int64, (n,), dev)
    build.require(prev, "prev", torch.int64, (n,), dev)
    build.require(keys, "keys", torch.int64, (n, 2), dev)
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = build.library("ervs")
    err = lib.repro_ervs_select(
        graph.indptr.data_ptr(), graph.indices.data_ptr(),
        graph.h.data_ptr(), rule.program, int(rule.weighted), rule.c0,
        rule.c2, cur.data_ptr(), prev.data_ptr(), keys.data_ptr(), n, tile,
        int(jump), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ervs_select")
    build.LAUNCHES["ervs_jump_select" if jump else "ervs_select"] += 1
    return out
