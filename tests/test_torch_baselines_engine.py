"""Port parity, part 17: the Table 2 baselines on the walk engine
(``PaddedRowSampler``: ``its``, ``als``, ``rvs_prefix``,
``rjs_maxreduce``).

* ``WalkEngine.run`` with each method gives the reference's paths and
  telemetry bit for bit, with fewer slots than queries (refills install
  new walkers mid-run) and an epoch length that does not divide the walk;
  ``rjs_maxreduce`` with a starved trial budget, so that ITS serves the
  walkers eRJS leaves unresolved;
* each method's draws from one walker state follow ``exact_probs``
  (chi-square, and the total variation distance);
* the registry, the config's trial budget of ``rjs_maxreduce``, the
  staged-only plan and the CLI.
"""
import numpy as np
import pytest
import torch

from _torch_port import chi2_vs_exact, one_torch_thread  # noqa: F401
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch.core import (EngineConfig, WalkEngine, available_samplers,
                              exact_probs, get_sampler)
from repro_torch.core.samplers import PaddedRowSampler
from repro_torch.graphs import power_law_graph
from repro_torch.kernels import baselines as kb
from repro_torch.kernels.prng import fold_in, key_data
from repro_torch.launch import walk as walk_cli
from repro_torch.walks import make_workload

METHODS = ("its", "als", "rvs_prefix", "rjs_maxreduce")
V, STEPS, SLOTS, EPOCH = 200, 6, 64, 4
TELEMETRY = ("frac_rjs", "frac_precomp", "rjs_fallbacks", "live_steps")
RUNS = [("its", "node2vec"), ("als", "metapath"), ("rvs_prefix", "2ndpr"),
        ("rjs_maxreduce", "visited_avoiding"), ("rjs_maxreduce", "node2vec")]


@pytest.fixture(scope="module")
def graphs():
    return ref_power_law(V, 8, seed=5), power_law_graph(V, 8, seed=5)


def _kw(method):
    # a starved budget: 1 trial a round, 4 rounds (rjs_maxreduce's 4x)
    return dict(method=method, tile=16, rjs_trials=1, rjs_max_rounds=1)


@pytest.mark.parametrize("method,name", RUNS)
def test_run_matches_reference(graphs, method, name):
    g, pg = graphs
    starts = np.arange(V)
    ref = RefEngine(g, ref_make_workload(name), RefConfig(**_kw(method))).run(
        starts, num_steps=STEPS, batch=SLOTS, epoch_len=EPOCH)
    eng = WalkEngine(pg, make_workload(name),
                     EngineConfig(device="cpu", **_kw(method)))
    got = eng.run(starts, num_steps=STEPS, batch=SLOTS, epoch_len=EPOCH)
    np.testing.assert_array_equal(ref.paths, got.paths)
    for f in TELEMETRY:
        assert getattr(ref, f) == getattr(got, f), f
    assert got.frac_rjs == 0.0 and got.rjs_fallbacks == 0
    assert eng.sampler_ctx.pad == eng.pad >= pg.max_degree()
    emitted = (got.paths[:, 1:] >= 0).sum()
    assert emitted > V  # MetaPath dead-ends often; the rest walk on


def test_maxreduce_falls_back_to_its(graphs):
    """With one trial a round some walkers exhaust eRJS's rounds; their
    steps come from ITS on the same keys."""
    _, pg = graphs
    pw = make_workload("node2vec")
    p = pw.params()
    cur = torch.arange(V, dtype=torch.int64).repeat(4)
    prev = torch.roll(cur, 1)
    step = torch.zeros_like(cur)
    keys = fold_in(key_data(1)[None, :], torch.arange(cur.shape[0]))
    pad = WalkEngine(pg, pw, EngineConfig(device="cpu")).pad
    bound = kb.row_max(pg, pw, p, cur, prev, step, pad=pad)
    from repro_torch.core.erjs import erjs_step
    _, fb, _ = erjs_step(pg, pw, p, cur, prev, step, keys, bound, 1, 4)
    assert 0 < int(fb.sum()) < cur.shape[0]
    got = kb.rjs_maxreduce_select(pg, pw, p, cur, prev, step, keys, pad=pad,
                                  trials_per_round=1, max_rounds=4)
    its = kb.its_select(pg, pw, p, cur, prev, step, keys, pad=pad)
    assert torch.equal(got[fb], its[fb])


@pytest.mark.parametrize("method", METHODS)
def test_draws_follow_exact_probs(graphs, method):
    _, pg = graphs
    pw = make_workload("node2vec")
    p = pw.params()
    deg = pg.degrees()
    v = int(torch.nonzero((deg >= 12) & (deg <= 40))[0])
    prev = int(pg.indices[pg.indptr[v]])
    n = 4000
    full = lambda x: torch.full((n,), x, dtype=torch.int64)
    keys = fold_in(key_data(7)[None, :], torch.arange(n))
    pad = WalkEngine(pg, pw, EngineConfig(device="cpu")).pad
    fn = kb.BASELINE_SELECT_FNS[method]
    out = fn(pg, pw, p, full(v), full(prev), full(0), keys, pad=pad).numpy()
    probs, nbr = exact_probs(pg, pw, p, v, prev, 0, pad)
    chi2, crit = chi2_vs_exact(out, probs, nbr)
    assert chi2 < crit, (chi2, crit)
    freq = np.array([(out == u).mean() for u in nbr[nbr >= 0]])
    assert 0.5 * np.abs(freq - probs[nbr >= 0]).sum() < 0.05


def test_registry_config_and_plan(graphs):
    assert set(METHODS) <= set(available_samplers())
    for m in METHODS:
        s = get_sampler(m)
        assert isinstance(s, PaddedRowSampler) and s.caps.needs_padded_row
        assert s.fused_kind(usable=True, has_precomp=False) is None
    cfg = EngineConfig(device="cpu", rjs_trials=3, rjs_max_rounds=5)
    extra = {k: f(cfg) for k, f in
             get_sampler("rjs_maxreduce")._extra_of_cfg.items()}
    assert extra == {"trials_per_round": 3, "max_rounds": 20}
    _, pg = graphs
    eng = WalkEngine(pg, make_workload("deepwalk"), EngineConfig(
        device="cpu", method="its", step_exec="fused"))
    assert eng.step_exec_resolved == "staged" and eng.precomp is None
    assert eng.sampler_ctx.pad == eng.pad
    # only a sampler that reads padded rows is handed their width
    eng = WalkEngine(pg, make_workload("deepwalk"), EngineConfig(
        device="cpu", method="adaptive"))
    assert not eng.sampler.caps.needs_padded_row
    assert eng.sampler_ctx.pad == 0 < eng.pad


def test_scratch_layout_and_launches(monkeypatch):
    """The wrapper's scratch words per walker (the kernels' layout), and
    launches split at the budget."""
    deg = torch.tensor([0, 1, 16, 17, 256, 257, 5000, 440_063])
    its = kb.scratch_words("its_row", deg)
    assert its.tolist() == [0, 1, 16, 17 + 2 * 2, 256 + 2 * 16,
                            257 + 2 * (17 + 2), 5000 + 2 * (313 + 20 + 2),
                            440_063 + 2 * (27_504 + 1_719 + 108 + 7)]
    als = kb.scratch_words("als_row", deg)
    assert als.tolist()[-2:] == [3 * 5000 + 157 + 5,
                                 3 * 440_063 + 13_752 + 430 + 14]
    chunks = kb._chunks(torch.tensor([5, 7, 3]))
    assert [(a, b, o.tolist()) for a, b, o in chunks] == [(0, 3, [0, 5, 12])]
    monkeypatch.setattr(kb, "SCRATCH_BUDGET", 4 * 10)
    chunks = kb._chunks(torch.tensor([5, 7, 3, 2, 30, 1]))
    assert [(a, b, o.tolist()) for a, b, o in chunks] == [
        (0, 1, [0]), (1, 3, [0, 7]), (3, 4, [0]), (4, 5, [0]), (5, 6, [0])]


def test_cli_runs_a_baseline_on_cpu(capsys):
    walk_cli.main(["--nodes", "200", "--queries", "20", "--steps", "4",
                   "--method", "its", "--device", "cpu"])
    assert "frac_rjs" in capsys.readouterr().out
