"""Wrapper of kernel K3 (``csrc/its.cu``): the ITS table draw, the port of
the TPU kernel ``repro/kernels/precomp_kernel.py:its_search``.

On CPU tensors it runs the plain version ``core.precomp.its_offsets``;
on CUDA tensors it launches the kernel (building it on first use) or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.precomp import PrecompTables, its_offsets
from repro_torch.kernels import build


def its_search(graph, tables: PrecompTables, cur: torch.Tensor,
               keys: torch.Tensor) -> torch.Tensor:
    """Row offset [n] (int64) the ITS draw picks for each walker at
    ``cur`` with per-step keys ``keys`` [n, 2]; -1 for empty or
    zero-total rows."""
    if cur.device.type == "cpu":
        return its_offsets(graph, tables, cur, keys)
    n = cur.shape[0]
    dev = cur.device
    V, E = graph.num_nodes, graph.num_edges
    build.require(graph.indptr, "graph.indptr", torch.int32, (V + 1,), dev)
    build.require(tables.cdf, "tables.cdf", torch.float32, (E,), dev)
    build.require(tables.total, "tables.total", torch.float32, (V,), dev)
    build.require(cur, "cur", torch.int64, (n,), dev)
    build.require(keys, "keys", torch.int64, (n, 2), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = build.library("its")
    err = lib.repro_its_search(
        graph.indptr.data_ptr(), tables.cdf.data_ptr(),
        tables.total.data_ptr(), cur.data_ptr(), keys.data_ptr(), n,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "its_search")
    build.LAUNCHES["its_search"] += 1
    return out
