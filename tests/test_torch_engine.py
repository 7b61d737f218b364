"""Port parity, part 4: the slice end to end.

``WalkEngine.run`` with method ``adaptive`` on node2vec and deepwalk over
a power-law graph, with a lowered ``jump_threshold`` and a small logical
tile so that every regime is taken (ITS tables, eRJS, plain eRVS, jump
eRVS, and — in the bound-starved configuration — eRJS fallbacks):

* every path equals the reference's up to its first divergence, and each
  first divergence is an eRVS near-tie;
* regime counts (rjs, fallbacks, precomp) are reported and match;
* chi-square of first and second transitions against ``exact_probs``;
* ``run(batch=k)`` and a ``batch`` / ``epoch_len`` refill run equal
  ``run()``;
* the CLI runs on the CPU, and asking for CUDA without a card raises.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from _torch_port import (chi2_vs_exact, node_offsets, one_torch_thread,  # noqa: F401
                         step_keys)
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import EngineConfig, WalkEngine, exact_probs
from repro_torch.core import ervs as ervs_mod
from repro_torch.core.types import WalkerState
from repro_torch.graphs import power_law_graph
from repro_torch.launch import walk as walk_cli
from repro_torch.walks import make_workload

V, STEPS, TILE, JUMP = 300, 8, 16, 4
CONFIGS = {
    "default": dict(),
    "starved": dict(rjs_trials=1, rjs_max_rounds=1),  # forces fallbacks
}
CASES = [("node2vec", "default"), ("node2vec", "starved"),
         ("deepwalk", "default")]


def _kw(cfg):
    """EngineConfig keywords of a case (shared by both packages)."""
    return dict(method="adaptive", tile=TILE, jump_threshold=JUMP,
                **CONFIGS[cfg])


@pytest.fixture(scope="module")
def graph():
    return power_law_graph(V, 8, seed=3)


@pytest.fixture(scope="module")
def runs(graph):
    """Reference and port results of every case (one reference run each)."""
    g = ref_power_law(V, 8, seed=3)
    assert np.array_equal(np.asarray(g.indices), graph.indices.numpy())
    out = {}
    for name, cfg in CASES:
        ref_eng = RefEngine(g, ref_make_workload(name), RefConfig(**_kw(cfg)))
        ref = ref_eng.run(np.arange(V), num_steps=STEPS)
        eng = WalkEngine(graph, make_workload(name),
                         EngineConfig(device="cpu", **_kw(cfg)))
        out[name, cfg] = (ref, eng, eng.run(np.arange(V), num_steps=STEPS))
        out[name, cfg, "ref_engine"] = ref_eng
    return out


def _regimes(eng, paths):
    """Lanes each regime served over the walk's states (the port's own
    partition of every state the walk passed through)."""
    q, t = np.nonzero(paths[:, 1:] >= 0)
    cur = torch.from_numpy(paths[q, t].astype(np.int64))
    prev = torch.from_numpy(np.where(t > 0, paths[q, np.maximum(t - 1, 0)],
                                     -1).astype(np.int64))
    state = WalkerState(cur=cur, prev=prev, step=torch.from_numpy(t),
                        alive=torch.ones(cur.shape, dtype=torch.bool),
                        rng=torch.zeros((cur.shape[0], 2), dtype=torch.int64))
    part = eng.sampler.partition(eng.sampler_ctx, state, state.alive,
                                  state.stream_keys())
    res = state.alive & ~part.want_pre & ~part.want_rjs
    lo, hi = eng.sampler.reservoir_split(eng.sampler_ctx, part, res)
    return dict(precomp=int(part.want_pre.sum()),
                rjs=int(part.want_rjs.sum()), ervs=int(lo.sum()),
                ervs_jump=int(hi.sum()))


def _first_divergence_is_near_tie(eng, ref_paths, got_paths, q):
    """The first step where query q's paths part is an eRVS near-tie."""
    t = int(np.nonzero(ref_paths[q] != got_paths[q])[0][0]) - 1
    cur = ref_paths[q, t]
    prev = ref_paths[q, t - 1] if t > 0 else -1
    one = lambda x: torch.tensor([x], dtype=torch.int64)
    state = WalkerState(cur=one(cur), prev=one(prev), step=one(t),
                        alive=torch.ones(1, dtype=torch.bool),
                        rng=torch.zeros((1, 2), dtype=torch.int64))
    ctx = eng.sampler_ctx
    part = eng.sampler.partition(ctx, state, state.alive,
                                 state.stream_keys())
    if bool(part.want_pre | part.want_rjs):
        return False  # ITS and eRJS decisions are bitwise: a port fault
    keys = interop.keys_from_arrays(step_keys(0, np.array([q]),
                                              np.array([t])))
    p = ctx.params
    if bool(part.deg[0] >= ctx.config.jump_threshold):
        lk, _ = ervs_mod.jump_lanes(ctx.graph, eng.workload, p, one(cur),
                                    one(prev), one(t), keys, TILE,
                                    state.alive)
        top = lk.topk(2, dim=1).values
        return bool(ervs_mod.within_ulps(top[:, 0], top[:, 1]))
    idx = (ctx.graph.indptr.numpy(), ctx.graph.indices.numpy())
    k = [ervs_mod.offset_keys_f64(
        ctx.graph, eng.workload, p, one(cur), one(prev), one(t), keys,
        torch.from_numpy(node_offsets(*idx, [cur], [nxt[q, t + 1]])), TILE)
        for nxt in (ref_paths, got_paths)]
    return bool(ervs_mod.within_ulps(k[0], k[1]))


@pytest.mark.parametrize("name,cfg", CASES)
def test_paths_match_reference_up_to_near_ties(runs, name, cfg):
    ref, eng, got = runs[name, cfg]
    same = (ref.paths == got.paths).all(axis=1)
    regimes = _regimes(eng, got.paths)
    print(f"{name}/{cfg}: {same.mean():.4f} of paths equal; regimes "
          f"{regimes}; frac_rjs={got.frac_rjs:.4f} "
          f"fallbacks={got.rjs_fallbacks} "
          f"frac_precomp={got.frac_precomp:.4f}")
    for q in np.nonzero(~same)[0]:
        assert _first_divergence_is_near_tie(eng, ref.paths, got.paths, q), \
            f"query {q}: first divergence is not an eRVS near-tie"
    if same.all():
        assert (got.frac_rjs, got.rjs_fallbacks, got.frac_precomp,
                got.live_steps) == (ref.frac_rjs, ref.rjs_fallbacks,
                                    ref.frac_precomp, ref.live_steps)
    if name == "deepwalk":
        assert regimes["precomp"] > 0 and regimes["ervs"] > 0
    else:
        assert min(regimes["rjs"], regimes["ervs"],
                   regimes["ervs_jump"]) > 0
    if cfg == "starved":
        assert got.rjs_fallbacks > 0


@pytest.mark.parametrize("name", ["node2vec", "deepwalk"])
def test_one_step_from_the_references_own_state(runs, name):
    """The reference's slot state after 3 steps (a scheduler with refills
    pending), handed over through ``repro_torch.interop`` together with
    its node statistics and tables: one port step gives the reference's
    next step — emitted nodes, state and telemetry."""
    ref_eng = runs[name, "default", "ref_engine"]
    _, eng, _ = runs[name, "default"]
    sched = ref_eng.scheduler(num_steps=STEPS, slots=V // 2, epoch_len=3)
    sched.admit(np.arange(V // 2), np.arange(V // 2))
    sched.run_epoch()
    s = sched.state
    after, emitted, stats = ref_eng.run_epoch_fn(
        s, sched.tables, sched.graph_view, sched.stats_view, epoch_len=1,
        num_steps=STEPS, pad=ref_eng.pad, max_tiles=ref_eng.max_tiles,
        fused=False)
    st = ref_eng.stats
    ctx = dataclasses.replace(eng.sampler_ctx, stats=interop.stats_from_arrays(
        st.h_min, st.h_max, st.h_sum, st.h_mean, st.degree, st.label_count))
    if ref_eng.precomp is not None:
        t = ref_eng.precomp
        ctx = dataclasses.replace(ctx, precomp=interop.tables_from_arrays(
            t.cdf, t.total, t.invalid))
    port = interop.state_from_arrays(s.cur, s.prev, s.step, s.alive, s.rng)
    saved, eng.sampler_ctx = eng.sampler_ctx, ctx
    try:
        nxt, out, pst = eng.step(port, STEPS)
    finally:
        eng.sampler_ctx = saved
    assert np.array_equal(np.asarray(emitted)[0], out.numpy())
    for field in ("cur", "prev", "step", "alive"):
        assert np.array_equal(np.asarray(getattr(after, field)),
                              getattr(nxt, field).numpy()), field
    assert stats.host_totals() == pst.host_totals()


@pytest.mark.parametrize("method", ["ervs", "ervs_jump", "erjs"])
def test_other_registered_samplers_match_reference(graph, method):
    """The slice's other registry entries on node2vec, parameters handed
    over from the reference program through ``interop``."""
    g = ref_power_law(V, 8, seed=3)
    wl = ref_make_workload("node2vec", a=1.5, b=0.75)
    kw = dict(method=method, tile=TILE)
    ref = RefEngine(g, wl, RefConfig(**kw)).run(np.arange(V), num_steps=4)
    pw = interop.program_from_params("node2vec", wl.params())
    got = WalkEngine(graph, pw, EngineConfig(device="cpu", **kw)).run(
        np.arange(V), num_steps=4)
    assert np.array_equal(ref.paths, got.paths)
    assert (ref.frac_rjs, ref.rjs_fallbacks) == (got.frac_rjs,
                                                 got.rjs_fallbacks)


@pytest.mark.parametrize("name", ["node2vec", "deepwalk"])
def test_batch_and_refill_runs_equal_the_full_run(runs, name):
    _, eng, full = runs[name, "default"]
    starts = np.arange(V)
    for batch, epoch_len in ((128, None), (200, 3)):
        part = eng.run(starts, num_steps=STEPS, batch=batch,
                       epoch_len=epoch_len)
        assert np.array_equal(part.paths, full.paths)
        assert (part.frac_rjs, part.frac_precomp, part.live_steps) == \
            (full.frac_rjs, full.frac_precomp, full.live_steps)


def test_run_reports_its_host_phase_split(runs):
    """``WalkResult.seconds`` splits run() on the host clock; the phases
    are disjoint, so they sum to no more than the call's own wall time."""
    _, eng, _ = runs["deepwalk", "default"]
    t0 = time.perf_counter()
    res = eng.run(np.arange(V), num_steps=STEPS, batch=64, epoch_len=2)
    wall = time.perf_counter() - t0
    assert set(res.seconds) == {"setup", "admit", "steps", "harvest"}
    assert all(s >= 0.0 for s in res.seconds.values())
    assert res.seconds["steps"] > 0.0
    assert sum(res.seconds.values()) <= wall


@pytest.mark.parametrize("name", ["node2vec", "deepwalk"])
def test_chi_square_first_and_second_transitions(graph, name):
    """2000 walks from one node: first steps against exact_probs(v), and
    second steps out of the most visited neighbour u against
    exact_probs(u, prev=v)."""
    eng = WalkEngine(graph, make_workload(name),
                     EngineConfig(device="cpu", **_kw("default")))
    deg = graph.degrees().numpy()
    v = int(np.argsort(deg)[-2])
    n = 2000
    res = eng.run(np.full(n, v), num_steps=2)
    p, nbr = exact_probs(eng.graph, eng.workload, eng.sampler_ctx.params, v,
                         -1, 0, eng.pad)
    chi2, crit = chi2_vs_exact(res.paths[:, 1], p, nbr)
    assert chi2 < crit, f"first step: chi2={chi2:.1f} >= {crit:.1f}"
    u = int(np.bincount(res.paths[:, 1]).argmax())
    sel = res.paths[:, 1] == u
    p, nbr = exact_probs(eng.graph, eng.workload, eng.sampler_ctx.params, u,
                         v, 1, eng.pad)
    chi2, crit = chi2_vs_exact(res.paths[sel, 2], p, nbr)
    assert chi2 < crit, f"second step: chi2={chi2:.1f} >= {crit:.1f}"


def test_cli_runs_on_cpu(capsys):
    walk_cli.main(["--nodes", "300", "--queries", "40", "--steps", "5",
                   "--device", "cpu", "--workload", "deepwalk",
                   "--batch", "16", "--epoch-len", "2"])
    out = capsys.readouterr().out
    assert "frac_precomp=" in out and "kernel launches" in out


def test_cuda_request_without_a_card_raises(graph):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is what this checks")
    with pytest.raises(RuntimeError, match="cuda"):
        WalkEngine(graph, make_workload("deepwalk"), EngineConfig())
