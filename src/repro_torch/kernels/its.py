"""Wrapper of kernel K3 (``csrc/its.cu``): the ITS table draw, the port of
the TPU kernel ``repro/kernels/precomp_kernel.py:its_search``.

On CPU tensors it runs the plain version ``core.precomp.its_offsets``;
on CUDA tensors it launches the kernel (building it on first use) or
raises.  The kernel reads the tables' node records
(``PrecompTables.draw_rows``) and fence table (``its_fence``) beside the
CDF.
"""
from __future__ import annotations

import torch

from repro_torch.core.precomp import FENCE_BLOCK, PrecompTables, its_offsets
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
    E = graph.num_edges
    rows = require_rows(graph, tables, dev)
    require_cdf(tables, E, dev)
    build.require(cur, "cur", torch.int64, (n,), dev)
    build.require(keys, "keys", torch.int64, (n, 2), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = build.library("its")
    err = lib.repro_its_search(
        rows.data_ptr(), tables.cdf.data_ptr(), tables.its_fence.data_ptr(),
        E, cur.data_ptr(), keys.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "its_search")
    build.LAUNCHES["its_search"] += 1
    return out


def require_cdf(tables: PrecompTables, E: int, dev) -> None:
    """Raise unless the tables' CDF and fence table are what the CUDA ITS
    draw reads: [E] and [E // FENCE_BLOCK] float32 on ``dev``, the CDF 16 B
    aligned (it is read a 16 B vector at a time)."""
    build.require(tables.cdf, "tables.cdf", torch.float32, (E,), dev)
    if tables.cdf.data_ptr() % 16:
        raise ValueError("tables.cdf must be 16-byte aligned")
    build.require(tables.its_fence, "tables.its_fence", torch.float32,
                  (E // FENCE_BLOCK,), dev)


def require_rows(graph, tables: PrecompTables, dev) -> torch.Tensor:
    """The tables' node records for ``graph`` (``draw_rows``), after
    checking what they are built from; raises unless both are on ``dev``
    with the shapes and types the CUDA draws read."""
    V = graph.num_nodes
    build.require(graph.indptr, "graph.indptr", torch.int32, (V + 1,), dev)
    build.require(tables.total, "tables.total", torch.float32, (V,), dev)
    return tables.draw_rows(graph.indptr)
