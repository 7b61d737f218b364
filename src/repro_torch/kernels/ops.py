"""Standalone kernel ops on the tile-aligned layout (port of
``repro/kernels/ops.py``).

:func:`align_rows` builds the tile-aligned CSR layout: every node's row
starts on a 128-lane boundary of a [R, 128] stream.  The walk engine does
not need it (its kernels read plain CSR offsets); the standalone ops below
do, as the reference's benchmarks and kernel tests drive them:

* :func:`ervs_select` — kernel K6 (``csrc/ervs_block.cu``), block-jump
  A-ExpJ over 1024-weight tiles;
* :func:`erjs_select` — kernel K7 (``csrc/erjs_block.cu``), bound-based
  rejection reading one stored weight per trial;
* :func:`its_search` / :func:`alias_pick` — the aligned entries of K3
  (``csrc/its.cu``: the plain binary search probe for probe, a short row
  read whole before its draw) and K5 (``csrc/alias.cu``), at flat starts
  ``row0 * 128``; both give the plain versions' answer on any values,
  rows clipped at the stream's ends and streams of any 4 B alignment;
* :func:`token_sample` — kernel K8 (``csrc/token_sample.cu``, wrapper
  ``token_sampler.py``), Gumbel-max sampling over LM logits, which needs
  no layout.

Each op runs its plain version (``kernels/ref.py``) on CPU tensors; on
CUDA tensors it launches its kernel (building it on first use) or raises.
As in the reference, a read outside the stream is clipped to it (ervs /
erjs clip the row, ITS / alias the flat index); streams built here put
every row inside.
The layout is built on the host with numpy and handed back as torch
tensors on the requested device.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build, ref, token_sampler
from repro_torch.kernels.prng import fold_in
from repro_torch.kernels.ref import LANES, SUBLANES

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32}


def _layout(row_start, row_deg, bucket_rows: bool):
    """(R, row0 [V] int64, src [E], dst [E]) of the aligned layout: value
    ``src[e]`` of the flat stream lands at ``dst[e]`` of the [R·128]
    stream."""
    starts = np.asarray(row_start, np.int64)
    degs = np.asarray(row_deg, np.int64)
    rows_per_node = np.maximum((degs + LANES - 1) // LANES, 0)
    row0 = np.zeros(degs.shape[0], np.int64)
    np.cumsum(rows_per_node[:-1], out=row0[1:])
    # a multiple of SUBLANES, with two tiles of slack past the last row
    R = int(rows_per_node.sum()) + SUBLANES * 2
    R = ((R + SUBLANES - 1) // SUBLANES) * SUBLANES
    if bucket_rows:
        R = max(SUBLANES, 1 << max(R - 1, 0).bit_length())
    E = int(degs.sum())
    node_of_edge = np.repeat(np.arange(degs.shape[0]), degs)
    bounds = np.zeros(degs.shape[0] + 1, np.int64)
    np.cumsum(degs, out=bounds[1:])
    within = np.arange(E, dtype=np.int64) - bounds[node_of_edge]
    src = starts[node_of_edge] + within
    dst = row0[node_of_edge] * LANES + within
    return R, row0, src, dst


def _scatter(values, R: int, src, dst, dtype, device) -> torch.Tensor:
    flat = np.zeros(R * LANES, dtype)
    flat[dst] = np.asarray(values, dtype)[src]
    return torch.from_numpy(flat.reshape(R, LANES)).to(
        device=device, dtype=_NP_TO_TORCH[np.dtype(dtype)])


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def align_rows_layout(values, row_start, row_deg, dtype=np.float32,
                      bucket_rows: bool = False, device="cuda"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`align_rows` for an explicit (row_start, row_deg) layout: row
    ``v`` is ``values[row_start[v] : row_start[v] + row_deg[v]]`` (a
    delta-overlay graph's layout; contiguous CSR is ``row_start ==
    indptr[:-1]``).  ``bucket_rows=True`` pads R up to a power of two
    (extra rows are zero).  Returns (w2d [R, 128] of ``dtype``, row0 [V]
    int32, degs [V] int32) on ``device``."""
    dev = resolve_device(device)
    degs = _host(row_deg)
    R, row0, src, dst = _layout(_host(row_start), degs, bucket_rows)
    w2d = _scatter(_host(values), R, src, dst, dtype, dev)
    return (w2d, torch.from_numpy(row0.astype(np.int32)).to(dev),
            torch.from_numpy(np.asarray(degs, np.int32)).to(dev))


def align_rows(values, indptr, dtype=np.float32, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Repack a flat CSR value stream into the tile-aligned [R, 128]
    layout: (w2d [R, 128] of ``dtype``, row0 [V] int32 — each node's first
    128-row, degs [V] int32), on ``device``."""
    indptr = _host(indptr).astype(np.int64)
    return align_rows_layout(values, indptr[:-1], np.diff(indptr),
                             dtype=dtype, device=device)


def graph_aligned_weights(graph):
    """Aligned layout of a graph's property weights h, on its device."""
    return align_rows(_host(graph.h), _host(graph.indptr),
                      device=graph.device)


def aligned_precomp_tables(tables, indptr):
    """Repack precomp tables' flat [E] arrays into the aligned layout
    (alias offsets ride the float32 stream, exact below 2^24).  Returns
    (cdf2d, prob2d, alias2d, row0, degs) on the tables' device; prob2d
    and alias2d are None for tables without alias arrays."""
    dev = tables.cdf.device
    indptr = _host(indptr).astype(np.int64)
    degs = np.diff(indptr)
    R, row0, src, dst = _layout(indptr[:-1], degs, False)
    streams = [None if a is None else
               _scatter(_host(a).astype(np.float32), R, src, dst,
                        np.float32, dev)
               for a in (tables.cdf, tables.alias_prob, tables.alias_off)]
    return (*streams, torch.from_numpy(row0.astype(np.int32)).to(dev),
            torch.from_numpy(degs.astype(np.int32)).to(dev))


def make_seeds(key: torch.Tensor, n: int) -> torch.Tensor:
    """[n, 2] Threefry seeds (int64 holding uint32) from key data [2]: the
    reference's ``key_data(split(key, n))``, which under jax's partitionable
    Threefry is ``fold_in(key, i)`` for i < n."""
    return fold_in(key, torch.arange(n, dtype=torch.int64,
                                     device=key.device))


# ------------------------------------------------------------ the ops
def _walkers(w2d, row0, degs, seeds, dev):
    """The walker count, once the inputs are what the kernels take."""
    W = row0.shape[0]
    build.require(w2d, "w2d", torch.float32, (w2d.shape[0], LANES), dev)
    build.require(row0, "row0", torch.int32, (W,), dev)
    build.require(degs, "degs", torch.int32, (W,), dev)
    build.require(seeds, "seeds", torch.int64, (W, 2), dev)
    return W


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ervs_tables(w2d, row0, degs):
    """K6's plan and table pass on CUDA tensors: the leaders of the
    distinct tabled rows, each walker's job, and the tables (tile sums,
    first counted positions, M), in the layout the walk kernel reads.
    Reads the plan's three counts back to size the tables (one
    synchronisation).  Scratch is kept across calls (``build.scratch``);
    what it holds is rebuilt by every call."""
    dev = w2d.device
    W, R = row0.shape[0], w2d.shape[0]
    stream = _stream(dev)
    lib = build.library("ervs_block")
    sc = lambda name, numel, dtype: build.scratch(
        f"ervs_block.{name}", dev, stream, max(numel, 1), dtype)
    t = SimpleNamespace(
        owner=sc("owner", R, torch.int32), src_of=sc("src_of", W, torch.int32),
        tb_of=sc("tb_of", W, torch.int32), mb_of=sc("mb_of", W, torch.int64),
        jobs=sc("jobs", W, torch.int32), order=sc("order", W, torch.int32),
        # the three totals, then the walk order's 2 x 64 slot counters
        counts=sc("counts", 3 + 64, torch.int64))
    build.check(lib.repro_ervs_block_plan(
        row0.data_ptr(), degs.data_ptr(), W, R,
        *(x.data_ptr() for x in (t.owner, t.src_of, t.tb_of, t.mb_of, t.jobs,
                                 t.order, t.counts)), stream),
        "ervs_block_plan")
    t.n_jobs, t.n_tiles, t.m_len = t.counts[:3].tolist()
    if t.n_tiles >= 2 ** 31:
        raise ValueError(f"ervs_select: {t.n_tiles} tiles to tabulate, "
                         f"more than an int32 indexes")
    t.tile_job = sc("tile_job", t.n_tiles, torch.int32)
    t.sums = sc("sums", t.n_tiles, torch.float32)
    t.firsts = sc("firsts", t.n_tiles, torch.int32)
    t.mtab = sc("mtab", t.m_len, torch.float32)
    if t.n_jobs:
        build.check(lib.repro_ervs_block_tables(
            w2d.data_ptr(), row0.data_ptr(), degs.data_ptr(), R,
            t.jobs.data_ptr(), t.n_jobs, t.n_tiles, t.tb_of.data_ptr(),
            t.mb_of.data_ptr(), t.tile_job.data_ptr(), t.sums.data_ptr(),
            t.firsts.data_ptr(), t.mtab.data_ptr(), stream),
            "ervs_block_tables")
    return t


def _ervs_check(w2d, row0, degs) -> int:
    """K6's walker count, once its stream and rows are what its kernels
    take."""
    dev, W = w2d.device, row0.shape[0]
    build.require(w2d, "w2d", torch.float32, (w2d.shape[0], LANES), dev)
    build.require(row0, "row0", torch.int32, (W,), dev)
    build.require(degs, "degs", torch.int32, (W,), dev)
    if W and w2d.shape[0] == 0:  # a clipped row index needs a row
        raise ValueError("w2d has no rows for the walkers to read")
    if dev.type == "cuda" and w2d.data_ptr() % 16:
        raise ValueError("w2d must be 16-byte aligned (K6 reads 16 B)")
    return W


def ervs_select(w2d, row0, degs, seeds):
    """Block-jump A-ExpJ reservoir selection, one walker per row (K6).
    Returns (offset [W] int32 or -1, draws [W] int32, jumped tiles [W]
    int32)."""
    W = _ervs_check(w2d, row0, degs)
    build.require(seeds, "seeds", torch.int64, (W, 2), w2d.device)
    if w2d.device.type == "cpu":
        return ref.ervs_select_ref(w2d, row0, degs, seeds)
    out = [torch.empty(W, dtype=torch.int32, device=w2d.device)
           for _ in range(3)]
    if W == 0:
        return tuple(out)
    t = _ervs_tables(w2d, row0, degs)
    err = build.library("ervs_block").repro_ervs_block_walk(
        w2d.data_ptr(), row0.data_ptr(), degs.data_ptr(), seeds.data_ptr(),
        W, w2d.shape[0],
        *(x.data_ptr() for x in (t.src_of, t.tb_of, t.mb_of, t.sums,
                                 t.firsts, t.mtab, t.order, *out)),
        _stream(w2d.device))
    build.check(err, "ervs_block_select")
    build.LAUNCHES["ervs_block_select"] += 1
    return tuple(out)


def ervs_tile_tables(w2d, row0, degs):
    """K6's tables as the walk reads them, for checks: (leaders [J] int64,
    ascending — the walkers whose rows the table pass tabulates, tile sums,
    first counted positions, M), each table concatenated in leader order
    as ``ref.ervs_tile_tables_ref`` gives them.  On CPU tensors, the plain
    versions (``ref.ervs_leaders_ref``, ``ref.ervs_tile_tables_ref``); on
    CUDA tensors, K6's plan and table kernels (not counted as a K6
    launch: they are not the whole kernel)."""
    W = _ervs_check(w2d, row0, degs)
    if w2d.device.type == "cpu" or W == 0:
        lead = ref.ervs_leaders_ref(row0, degs, w2d.shape[0])
        return (lead, *ref.ervs_tile_tables_ref(w2d, row0[lead], degs[lead]))
    t = _ervs_tables(w2d, row0, degs)
    lead = torch.sort(t.jobs[:t.n_jobs].to(torch.int64)).values
    d = degs[lead].to(torch.int64)
    tiles = ref._ranges(t.tb_of[lead], (d + ref.TILE - 1) // ref.TILE)
    ms = ref._ranges(t.mb_of[lead], (d + 31) // 32 * 32)
    return lead, t.sums[tiles], t.firsts[tiles], t.mtab[ms]


def erjs_select(w2d, row0, degs, bounds, seeds, trials: int = 8,
                max_rounds: int = 16):
    """Bound-based rejection, at most ``trials * max_rounds`` trials (K7).
    Returns (offset [W] int32, -1 when none was accepted, trials [W]
    int32)."""
    if trials < 1 or max_rounds < 1:
        raise ValueError(f"trials and max_rounds must be positive, got "
                         f"{trials} and {max_rounds}")
    if w2d.device.type == "cpu":
        return ref.erjs_select_ref(w2d, row0, degs, bounds, seeds, trials,
                                   max_rounds)
    W = _walkers(w2d, row0, degs, seeds, w2d.device)
    build.require(bounds, "bounds", torch.float32, (W,), w2d.device)
    off, used = (torch.empty(W, dtype=torch.int32, device=w2d.device)
                 for _ in range(2))
    if W == 0:
        return off, used
    err = build.library("erjs_block").repro_erjs_block_select(
        w2d.data_ptr(), row0.data_ptr(), degs.data_ptr(), bounds.data_ptr(),
        seeds.data_ptr(), W, w2d.shape[0], trials * max_rounds,
        off.data_ptr(), used.data_ptr(), _stream(w2d.device))
    build.check(err, "erjs_block_select")
    build.LAUNCHES["erjs_block_select"] += 1
    return off, used


def its_search(cdf2d, row0, degs, totals, seeds):
    """ITS draw by binary search of the aligned CDF stream (K3's aligned
    entry).  Returns offset [W] int32, -1 for empty or zero-total rows."""
    if cdf2d.device.type == "cpu":
        return ref.its_search_ref(cdf2d, row0, degs, totals, seeds)
    W = _walkers(cdf2d, row0, degs, seeds, cdf2d.device)
    build.require(totals, "totals", torch.float32, (W,), cdf2d.device)
    out = torch.empty(W, dtype=torch.int32, device=cdf2d.device)
    if W == 0:
        return out
    err = build.library("its").repro_its_search_aligned(
        cdf2d.data_ptr(), row0.data_ptr(), degs.data_ptr(),
        totals.data_ptr(), seeds.data_ptr(), W, cdf2d.numel() - 1,
        out.data_ptr(), _stream(cdf2d.device))
    build.check(err, "its_search_aligned")
    build.LAUNCHES["its_search_aligned"] += 1
    return out


def alias_pick(prob2d, alias2d, row0, degs, totals, seeds):
    """Alias draw on the aligned streams (K5's aligned entry).  Returns
    offset [W] int32, -1 for empty or zero-total rows."""
    if prob2d.device.type == "cpu":
        return ref.alias_pick_ref(prob2d, alias2d, row0, degs, totals, seeds)
    dev = prob2d.device
    W = _walkers(prob2d, row0, degs, seeds, dev)
    build.require(alias2d, "alias2d", torch.float32, tuple(prob2d.shape), dev)
    build.require(totals, "totals", torch.float32, (W,), dev)
    out = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return out
    err = build.library("alias").repro_alias_pick_aligned(
        prob2d.data_ptr(), alias2d.data_ptr(), row0.data_ptr(),
        degs.data_ptr(), totals.data_ptr(), seeds.data_ptr(), W,
        prob2d.numel() - 1, out.data_ptr(), _stream(dev))
    build.check(err, "alias_pick_aligned")
    build.LAUNCHES["alias_pick_aligned"] += 1
    return out


def token_sample(logits, seed, temperature: float = 1.0,
                 greedy: bool = False):
    """Gumbel-max categorical token sampling (K8; see token_sampler.py).
    Returns token ids [B] int32."""
    return token_sampler.token_sample(logits, seed, temperature, greedy)
