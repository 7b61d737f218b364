"""K1's interleaved entry and this slice's engine paths on the card
(``cuda`` marker; they skip where there is no card):

* ``ervs_interleaved_select`` chooses what plain K1 (``ervs_select``)
  chooses, bitwise, under hand rules (deepwalk, node2vec and its
  unweighted variant, metapath, 2ndpr, visited_avoiding) and generated
  ones (the quickstart program, stripped node2vec), at tiles 8, 64 and
  256, with about half the lanes hitting the carry; the carry it leaves
  holds the chosen node's first ``min(deg, tile)`` entries as the plain
  version writes them and tag -1 on every other slot;
* an ``interleaved`` engine launches K1's interleaved entry (never its
  plain version) and gives the ``ervs`` engine's paths and telemetry;
* ``precomp_exec="aligned"`` engines launch the aligned entries of K3 /
  K5 and give the flat engines' paths; ``walk_batch`` fused equals staged
  and a scheduler's ``kill`` keeps the killed walkers' prefixes.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q -m cuda \\
        tests/test_torch_interleaved_card.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import cuda_device, one_torch_thread  # noqa: F401
from repro_torch.core import EngineConfig, WalkEngine
from repro_torch.core import ervs as ervs_mod
from repro_torch.core.samplers import InterleavedSampler
from repro_torch.core.types import WalkerState
from repro_torch.graphs import power_law_graph
from repro_torch.kernels import build
from repro_torch.kernels import ervs as k1
from repro_torch.kernels.prng import key_data
from repro_torch.walks import make_workload
from repro_torch.walks.examples import degree_damped, stripped

PROGRAMS = {
    "deepwalk": lambda: make_workload("deepwalk"),
    "node2vec": lambda: make_workload("node2vec"),
    "node2vec_unweighted": lambda: make_workload("node2vec_unweighted"),
    "metapath": lambda: make_workload("metapath"),
    "2ndpr": lambda: make_workload("2ndpr"),
    "visited_avoiding": lambda: make_workload("visited_avoiding"),
    "gen:degree_damped": degree_damped,
    "gen:node2vec": lambda: stripped(make_workload("node2vec")),
}


@pytest.fixture(scope="module")
def card_graph():
    if not torch.cuda.is_available():
        return None
    return power_law_graph(3000, 10, seed=2).to("cuda")


def _walkers(graph, program, n: int, seed: int):
    """n walkers one engine step into their walks (state on the card):
    their slots, cur, prev, step, keys and program state."""
    eng = WalkEngine(graph, program, EngineConfig(method="ervs"))
    rng = np.random.default_rng(seed)
    starts = torch.from_numpy(rng.integers(0, graph.num_nodes, n)).cuda()
    state = WalkerState.create(starts, key_data(seed),
                               wstate=program.init_wstate_batch(
                                   torch.arange(n, device="cuda")))
    state, _, _ = eng.step(state, 80)
    return eng, state


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 64, 256])
@pytest.mark.parametrize("pname", list(PROGRAMS))
def test_interleaved_entry_matches_plain_k1(cuda_device, card_graph, pname,
                                            tile):
    g = card_graph
    program = PROGRAMS[pname]()
    n = 600
    eng, state = _walkers(g, program, n, seed=5)
    params = eng.sampler_ctx.params
    # the carry a step behind, over more slots than walkers: every other
    # walker's tag is its node (a hit, with its row's first tile), the
    # rest tagged elsewhere (a miss)
    W = n + 37
    ctx = dataclasses.replace(eng.sampler_ctx, config=dataclasses.replace(
        eng.config, tile=tile))
    carry = InterleavedSampler().init_carry(ctx, W)
    lanes = torch.randperm(W, device=cuda_device)[:n]
    hit = torch.arange(n, device=cuda_device) % 2 == 0
    tag = torch.where(hit, state.cur, (state.cur + 1) % g.num_nodes)
    nbr, h, label, _ = ervs_mod.tile0_payload(g, program, tag, tile)
    carry.node[lanes] = tag
    carry.nbr[lanes] = nbr.to(torch.int32)
    carry.h[lanes] = h
    carry.label[lanes] = label.to(torch.int32)
    keys = state.stream_keys()
    live = (state.alive & (ervs_mod.degrees_of(g, state.cur) > 0))
    idx = live.nonzero().squeeze(1)
    cur, prev, step, kk = (x[idx].contiguous() for x in (
        state.cur, state.prev, state.step, keys))
    ws = None if state.wstate is None else tuple(
        leaf[idx].contiguous() for leaf in state.wstate)
    sl = lanes[idx].contiguous()
    want = k1.ervs_select(g, program, params, cur, prev, step, kk, tile=tile,
                          wstate=ws)
    build.reset_launches()
    got = k1.ervs_interleaved_select(g, program, params, cur, prev, step, kk,
                                     carry, sl, tile=tile, wstate=ws)
    assert build.LAUNCHES["ervs_interleaved_select"] == 1
    assert torch.equal(got, want)
    others = torch.ones(W, dtype=torch.bool, device=cuda_device)
    others[sl] = False
    assert bool((carry.node[others] == -1).all())
    assert torch.equal(carry.node[sl], got)
    nbr, h, label, mask = ervs_mod.tile0_payload(g, program, got, tile)
    for leaf, plain in ((carry.nbr, nbr), (carry.h, h), (carry.label, label)):
        row = leaf[sl]
        assert torch.equal(torch.where(mask, row, 0),
                           torch.where(mask, plain.to(row.dtype), 0))


@pytest.mark.cuda
@pytest.mark.parametrize("pname", ["node2vec", "metapath",
                                   "gen:degree_damped"])
def test_interleaved_engine_runs_its_kernel(cuda_device, card_graph, pname,
                                            monkeypatch):
    g = card_graph
    starts = np.arange(g.num_nodes)
    runs = {}
    for method in ("ervs", "interleaved"):
        eng = WalkEngine(g, PROGRAMS[pname](), EngineConfig(method=method,
                                                            tile=64))
        if method == "interleaved":
            monkeypatch.setattr(k1, "interleaved_step", None)  # never plain
        build.reset_launches()
        runs[method] = (eng.run(starts, num_steps=12, batch=1000,
                                epoch_len=5), dict(build.LAUNCHES))
    (a, la), (b, lb) = runs["ervs"], runs["interleaved"]
    assert lb["ervs_interleaved_select"] > 0 and lb["ervs_select"] == 0
    np.testing.assert_array_equal(a.paths, b.paths)
    assert (a.live_steps, a.frac_rjs) == (b.live_steps, b.frac_rjs)


@pytest.mark.cuda
@pytest.mark.parametrize("method,kernel", [
    ("its_precomp", "its_search_aligned"),
    ("alias_precomp", "alias_pick_aligned")])
def test_aligned_engine_draws_on_the_card(cuda_device, card_graph, method,
                                          kernel):
    g = card_graph
    starts = np.arange(g.num_nodes)
    res = {}
    for exec_ in ("flat", "aligned"):
        eng = WalkEngine(g, make_workload("deepwalk"), EngineConfig(
            method=method, step_exec="staged", precomp_exec=exec_))
        build.reset_launches()
        res[exec_] = eng.run(starts, num_steps=10)
        if exec_ == "aligned":
            assert build.LAUNCHES[kernel] > 0
    np.testing.assert_array_equal(res["flat"].paths, res["aligned"].paths)
    assert res["flat"].frac_precomp == res["aligned"].frac_precomp > 0


@pytest.mark.cuda
def test_walk_batch_and_kill_on_the_card(cuda_device, card_graph):
    g = card_graph
    starts = np.arange(2048) % g.num_nodes
    out = {}
    for ex in ("fused", "staged"):
        eng = WalkEngine(g, make_workload("deepwalk"), EngineConfig(
            method="its_precomp", step_exec=ex))
        out[ex] = eng.walk_batch(starts, key_data(3), 9)
        assert eng.step_exec_resolved == ex
    assert torch.equal(out["fused"][0], out["staged"][0])
    for a, b in zip(out["fused"][1].__dict__.values(),
                    out["staged"][1].__dict__.values()):
        assert torch.equal(a, b)
    run = eng.run(starts, num_steps=9, key=key_data(3))
    np.testing.assert_array_equal(run.paths[:, 1:],
                                  out["staged"][0].cpu().numpy())
    s = eng.scheduler(num_steps=9, key=key_data(3), slots=2048, epoch_len=3,
                      capacity=2048)
    s.admit(np.arange(2048), starts)
    s.run_epoch()
    killed = s.kill(np.arange(0, 2048, 97))
    assert killed.size and np.isin(killed, np.arange(0, 2048, 97)).all()
    while s.busy:
        s.run_epoch()
    keep = np.ones(2048, bool)
    keep[killed] = False
    np.testing.assert_array_equal(s.paths[keep], run.paths[keep])
    np.testing.assert_array_equal(s.paths[killed, :4], run.paths[killed, :4])
    assert (s.paths[killed, 4:] == -1).all()
