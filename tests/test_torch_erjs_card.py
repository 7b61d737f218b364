"""K2 and K4's scalar regimes on the card, on the eRJS walker sets.

Both run the trials of ``csrc/erjs.cuh``: round 0 on the walker's lane,
the later rounds by its whole warp, 32 trials a pass.  Here each kernel
is held bit for bit against its plain PyTorch version on the same card
tensors, on the walker sets of ``_torch_port.erjs_walkers`` (first
accepts at the first trial, at round and 32-trial pass boundaries and at
the last trial; walkers that fall back, rows of zero weight, nodes
without edges, bounds of 0) under every budget of ``ERJS_BUDGETS``:

* K2 under every device rule: next node, fallback and proposals made,
  which must also be the proposals the set was built for; then on the
  first 2,048 walkers of the whole pool;
* K4's rejection instance, hook-free (deepwalk) and hooked (ppr_nibble),
  12 steps from the set's walkers, with per-node bounds 1 to 64 times
  the row's largest weight (many walkers pending after round 0, and
  fallbacks);
* K4's ITS and alias instances with every third row stale, so that warps
  mix table draws and warp-wide row scans.

K4 is held on its emitted nodes, flag words and end state (PPR-Nibble's
mass included).  Every test needs the card (``cuda`` marker); this file
imports no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import (ERJS_BUDGETS, ERJS_PROGRAMS,  # noqa: F401
                         cuda_device, erjs_pool, erjs_walkers,
                         one_torch_thread)
from repro_torch import interop
from repro_torch.core.erjs import erjs_step
from repro_torch.core.precomp import build_tables
from repro_torch.core.types import WalkerState
from repro_torch.kernels import megastep
from repro_torch.kernels.erjs import erjs_select
from repro_torch.walks import make_workload

BUDGET_IDS = [f"{k}x{r}" for k, r in ERJS_BUDGETS]
POOL_WALKERS = 2048
K4_STEPS = 12


def _inputs(s, dev, n=None):
    """(graph, cur, prev, step, keys, bound, wstate) of walker set ``s`` on
    ``dev``; the first ``n`` walkers when given."""
    cut = slice(None if n is None else n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.asarray(a[cut], np.int64))).to(dev)
    ws = None if s["ws"] is None else np.ascontiguousarray(s["ws"][cut])
    return (interop.graph_from_arrays(*s["arrays"], device=dev),
            t(s["cur"]), t(s["prev"]), t(s["step"]),
            interop.keys_from_arrays(np.ascontiguousarray(s["kd"][cut]),
                                     device=dev),
            torch.from_numpy(np.ascontiguousarray(s["bound"][cut])).to(dev),
            interop.wstate_from_arrays(ws, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("trials,rounds", ERJS_BUDGETS, ids=BUDGET_IDS)
@pytest.mark.parametrize("name", ERJS_PROGRAMS)
def test_k2_matches_plain_version(name, trials, rounds, cuda_device):
    pw = make_workload(name)
    p = pw.params()
    s = erjs_walkers(name, trials, rounds)
    for n, sets in ((None, s), (POOL_WALKERS, erjs_pool(name))):
        g, cur, prev, step, keys, bound, ws = _inputs(sets, cuda_device, n)
        got = erjs_select(g, pw, p, cur, prev, step, keys, bound,
                          trials=trials, rounds=rounds, wstate=ws)
        want = erjs_step(g, pw, p, cur, prev, step, keys, bound, trials,
                         rounds, wstate=ws)
        for a, b, what in zip(got, want, ("next", "fallback", "used")):
            assert torch.equal(a, b), f"{what} differs on " \
                                      f"{int((a != b).sum())} walkers"
        if n is None:
            assert np.array_equal(got[2].cpu().numpy(), s["used"])


def _state(s, pw, dev):
    g, cur, prev, step, keys, _, _ = _inputs(s, dev)
    W = cur.numel()
    alive = torch.ones(W, dtype=torch.bool, device=dev)
    alive[::11] = False
    step[::7] = 80 - 5  # these stop inside the epoch
    return g, WalkerState(cur=cur, prev=prev, step=step, alive=alive,
                          rng=keys,
                          wstate=pw.init_wstate_batch(torch.arange(
                              W, device=dev)))


def _same_epoch(got, want):
    (s1, e1, f1), (s2, e2, f2) = got, want
    assert torch.equal(e1, e2) and torch.equal(f1, f2)
    for f in ("cur", "prev", "step", "alive"):
        assert torch.equal(getattr(s1, f), getattr(s2, f))
    for a, b in zip(s1.wstate or (), s2.wstate or ()):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("trials,rounds", ERJS_BUDGETS, ids=BUDGET_IDS)
@pytest.mark.parametrize("name", ["deepwalk", "ppr_nibble"])
def test_k4_rejection_matches_plain_version(name, trials, rounds,
                                            cuda_device):
    pw = make_workload(name)
    p = pw.params()
    g, state = _state(erjs_walkers(name, trials, rounds), pw, cuda_device)
    indptr = g.indptr.cpu().numpy().astype(np.int64)
    h = g.h.cpu().numpy()
    hmax = np.array([h[a:b].max(initial=0.0)
                     for a, b in zip(indptr[:-1], indptr[1:])])
    scale = 2.0 ** np.random.default_rng(25).integers(0, 7, hmax.size)
    bmax = torch.from_numpy((hmax * scale).astype(np.float32)).to(
        cuda_device)
    args = dict(kind="rejection", tile=256, rjs_trials=trials,
                rjs_max_rounds=rounds, epoch_len=K4_STEPS, num_steps=80,
                bmax=bmax)
    got = megastep.fused_epoch(g, pw, p, state, **args)
    want = megastep.fused_epoch_plain(g, pw, p, state, **args)
    _same_epoch(got, want)
    if rounds > 1:
        assert bool(((want[2] >> 2) & 1).any()), "no walker fell back"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["precomp_its", "precomp_alias"])
@pytest.mark.parametrize("name", ["deepwalk", "ppr_nibble"])
def test_k4_tables_with_stale_rows_match_plain_version(name, kind,
                                                       cuda_device):
    pw = make_workload(name)
    p = pw.params()
    g, state = _state(erjs_walkers(name, 8, 16), pw, cuda_device)
    tables = build_tables(g, pw, p)
    invalid = tables.invalid.clone()
    invalid[::3] = True
    args = dict(kind=kind, tile=256, rjs_trials=8, rjs_max_rounds=16,
                epoch_len=K4_STEPS, num_steps=80,
                tables=dataclasses.replace(tables, invalid=invalid))
    got = megastep.fused_epoch(g, pw, p, state, **args)
    want = megastep.fused_epoch_plain(g, pw, p, state, **args)
    _same_epoch(got, want)
    flags = want[2]
    assert bool(((flags >> 3) & 1).any()) and bool(((flags >> 4) & 1).any())
