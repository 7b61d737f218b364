"""K9–K12, the Table 2 baselines' row kernels, on the card.

Each kernel is held bit for bit against its plain PyTorch version
(``repro_torch/core/baselines.py``, run on CPU copies of the same inputs)
on ``baseline_rows_graph``'s rows: 1 to 24 neighbours with zero-weight
runs, an empty row, a star row of 5,000 (four scan levels), keys whose ITS
target lies within an ulp of the total, at the engine's pad and at a
larger one; under the hand rules of six programs, a stripped program's
generated rule and two user programs' (one reads its wstate).  K12 feeds
K2 and K9 in ``rjs_maxreduce_select``; launches split at a small scratch
budget give the same bits; a CUDA input of the wrong kind raises.  Every
test needs the card (``cuda`` marker); this file imports no JAX.
"""
import numpy as np
import pytest
import torch

from _torch_port import (baseline_rows_graph, baseline_walkers,  # noqa: F401
                         cuda_device, one_torch_thread)
from repro_torch import interop
from repro_torch.core import baselines as plain
from repro_torch.kernels import baselines as kb
from repro_torch.kernels import build
from repro_torch.walks import examples, make_workload

pytestmark = pytest.mark.cuda

PROGRAMS = ["node2vec", "node2vec_unweighted", "metapath", "2ndpr",
            "deepwalk", "visited_avoiding", "ppr_nibble", "gen:node2vec",
            "user:degree_damped", "user:non_backtracking"]
KINDS = ("its", "rvs_prefix", "als", "row_max")
PAD = 8192


def _program(name):
    if name.startswith("gen:"):
        return examples.stripped(make_workload(name[4:]))
    if name.startswith("user:"):
        return getattr(examples, name[5:])()
    return make_workload(name)


def _inputs(name, dev, n=240):
    """(graph, program, params, cur, prev, step, keys, wstate) on ``dev``."""
    arrays = baseline_rows_graph(11)
    cur, prev, step, kd, ring = baseline_walkers(arrays[0], arrays[1], n, 12)
    g = interop.graph_from_arrays(*arrays, device=dev)
    pw = _program(name)
    i64 = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    ws = None
    if pw.wstate_template() is not None:
        if name == "visited_avoiding":
            ws = (torch.from_numpy(ring).to(dev),)
        elif name == "user:non_backtracking":
            ws = (torch.from_numpy(prev.astype(np.int32)).to(dev),)
        else:
            rng = np.random.default_rng(3)
            ws = tuple(torch.from_numpy(rng.random(
                (n,) + tuple(x.shape)).astype(np.float32)).to(dev).to(x.dtype)
                for x in pw.wstate_template())
    return (g, pw, pw.params(), i64(cur), i64(prev), i64(step),
            interop.keys_from_arrays(kd, device=dev), ws)


def _cpu(args):
    g, pw, p, *rest = args
    ws = rest[-1]
    cpu = lambda t: t.cpu()
    gc = interop.graph_from_arrays(*(x.cpu().numpy() for x in (
        g.indptr, g.indices, g.h, g.labels)))
    return (gc, pw, p, *map(cpu, rest[:-1]),
            None if ws is None else tuple(map(cpu, ws)))


def _run(kind, args, pad, on_card):
    g, pw, p, cur, prev, step, keys, ws = args
    if kind == "row_max":
        fn = kb.row_max if on_card else plain.row_max
        return (fn(g, pw, p, cur, prev, step, pad=pad, wstate=ws) if on_card
                else fn(g, pw, p, cur, prev, step, pad, wstate=ws))
    if on_card:
        return kb.BASELINE_SELECT_FNS[kind](g, pw, p, cur, prev, step, keys,
                                            pad=pad, wstate=ws)
    return plain.BASELINE_STEP_FNS[kind](g, pw, p, cur, prev, step, keys,
                                         pad, wstate=ws)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", PROGRAMS)
def test_kernel_matches_plain(cuda_device, kind, name):
    args = _inputs(name, cuda_device)
    build.reset_launches()
    for pad in (PAD, 4 * PAD):
        got = _run(kind, args, pad, True).cpu()
        want = _run(kind, _cpu(args), pad, False)
        if kind == "row_max":
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            assert torch.equal(got, want), (got != want).nonzero()[:8]
    launched = {"its": "its_row", "rvs_prefix": "rvs_prefix_row",
                "als": "als_row", "row_max": "row_max"}[kind]
    assert build.LAUNCHES[launched] == 2


@pytest.mark.parametrize("name", ["node2vec", "2ndpr", "visited_avoiding"])
def test_maxreduce_composes_k12_k2_k9(cuda_device, name):
    args = _inputs(name, cuda_device)
    g, pw, p, cur, prev, step, keys, ws = args
    cg, _, _, ccur, cprev, cstep, ckeys, cws = _cpu(args)
    build.reset_launches()
    got = kb.rjs_maxreduce_select(g, pw, p, cur, prev, step, keys, pad=PAD,
                                  trials_per_round=1, max_rounds=2,
                                  wstate=ws).cpu()
    want = plain.rjs_maxreduce_step(cg, pw, p, ccur, cprev, cstep, ckeys,
                                    PAD, trials_per_round=1, max_rounds=2,
                                    wstate=cws)
    assert torch.equal(got, want)
    assert build.LAUNCHES["row_max"] == 1
    assert build.LAUNCHES["erjs_select"] == 1
    assert build.LAUNCHES["its_row"] == 1  # some walkers fell back


def test_launches_split_at_the_budget(cuda_device, monkeypatch):
    args = _inputs("node2vec", cuda_device)
    whole = {k: _run(k, args, PAD, True) for k in ("its", "rvs_prefix", "als")}
    monkeypatch.setattr(kb, "SCRATCH_BUDGET", 4 * 20_000)
    build.reset_launches()
    for k, want in whole.items():
        assert torch.equal(_run(k, args, PAD, True), want)
    assert build.LAUNCHES["its_row"] > 2 and build.LAUNCHES["als_row"] > 2


def test_cuda_wrappers_raise_on_bad_inputs(cuda_device):
    g, pw, p, cur, prev, step, keys, ws = _inputs("deepwalk", cuda_device)
    for fn in kb.BASELINE_SELECT_FNS.values():
        with pytest.raises(TypeError):
            fn(g, pw, p, cur.int(), prev, step, keys, pad=PAD)
        with pytest.raises(ValueError):
            fn(g, pw, p, cur, prev, step, keys.cpu(), pad=PAD)
    with pytest.raises(TypeError):
        kb.row_max(g, pw, p, cur, prev.int(), step, pad=PAD)
    # the visited rule reads the rings: no wstate is an error, not a guess
    g, pw, p, cur, prev, step, keys, ws = _inputs("visited_avoiding",
                                                  cuda_device)
    with pytest.raises(ValueError):
        kb.its_select(g, pw, p, cur, prev, step, keys, pad=PAD)
