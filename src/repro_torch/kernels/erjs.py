"""Wrapper of kernel K2 (``csrc/erjs.cu``): per-step eRJS selection.

On CPU tensors it runs the plain version ``core.erjs.erjs_step``; on CUDA
tensors it launches the kernel (building it on first use) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.erjs import erjs_step
from repro_torch.kernels import build
from repro_torch.kernels.ervs import kernel_rule, walker_inputs


def erjs_select(graph, program, params, cur, prev, step, keys, bound, *,
                trials: int = 8, rounds: int = 16, wstate=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(next [n] int64, needs_fallback [n] bool, proposals made [n] int32)
    for the n walkers at ``cur`` with per-walker bounds ``bound`` [n] and
    program state ``wstate``."""
    if cur.device.type == "cpu":
        return erjs_step(graph, program, params, cur, prev, step, keys,
                         bound, trials_per_round=trials, max_rounds=rounds,
                         wstate=wstate)
    rule = kernel_rule(program, params)
    n = cur.shape[0]
    dev = cur.device
    ring, leaves = walker_inputs(graph, rule, cur, prev, step, keys, wstate,
                                 dev)
    build.require(bound, "bound", torch.float32, (n,), dev)
    if trials < 1 or rounds < 1:
        raise ValueError(f"trials and rounds must be positive, got "
                         f"{trials} and {rounds}")
    out = torch.empty(n, dtype=torch.int64, device=dev)
    fallback = torch.empty(n, dtype=torch.bool, device=dev)
    used = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out, fallback, used
    lib = build.library("erjs", rule.header)
    rs = rule.as_struct()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the walkers left after round 0, listed for the later rounds' launch
    todo = build.scratch("erjs.todo", dev, stream, n + 1, torch.int32)
    err = lib.repro_erjs_select(
        graph.indptr.data_ptr(), graph.indices.data_ptr(),
        graph.h.data_ptr(), graph.labels.data_ptr(), ctypes.byref(rs),
        cur.data_ptr(), prev.data_ptr(), step.data_ptr(), ring, leaves,
        keys.data_ptr(), bound.data_ptr(), n, trials, rounds, out.data_ptr(),
        fallback.data_ptr(), used.data_ptr(), todo.data_ptr(), stream)
    build.check(err, "erjs_select")
    build.LAUNCHES["erjs_select"] += 1
    return out, fallback, used
