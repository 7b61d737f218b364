"""Wrapper of kernel K5 (``csrc/alias.cu``): the alias table draw, the
port of the TPU kernel ``repro/kernels/precomp_kernel.py:alias_pick``.

On CPU tensors it runs the plain version ``core.precomp.alias_offsets``;
on CUDA tensors it launches the kernel (building it on first use) or
raises.  The kernel reads the tables' node records
(``PrecompTables.draw_rows``) and pair table (``alias_pair``).
"""
from __future__ import annotations

import torch

from repro_torch.core.precomp import PrecompTables, alias_offsets
from repro_torch.kernels import build
from repro_torch.kernels.its import require_rows


def alias_pick(graph, tables: PrecompTables, cur: torch.Tensor,
               keys: torch.Tensor) -> torch.Tensor:
    """Row offset [n] (int64) the alias draw picks for each walker at
    ``cur`` with per-step keys ``keys`` [n, 2]; -1 for empty or
    zero-total rows."""
    if cur.device.type == "cpu":
        return alias_offsets(graph, tables, cur, keys)
    tables.require_alias()
    n = cur.shape[0]
    dev = cur.device
    rows = require_rows(graph, tables, dev)
    build.require(tables.alias_pair, "tables.alias_pair", torch.int32,
                  (graph.num_edges, 2), dev)
    build.require(cur, "cur", torch.int64, (n,), dev)
    build.require(keys, "keys", torch.int64, (n, 2), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = build.library("alias")
    err = lib.repro_alias_pick(
        rows.data_ptr(), tables.alias_pair.data_ptr(), cur.data_ptr(),
        keys.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "alias_pick")
    build.LAUNCHES["alias_pick"] += 1
    return out
