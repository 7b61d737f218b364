"""Port parity, part 10: the Fig. 13 selector baselines ``random`` and
``degree`` (``PartitionedSampler`` with the coin-flip and degree-threshold
policies: eRJS or plain eRVS per lane, no tables, no jump reservoir).

* the random policy's coin equals ``jax.random.bernoulli(fold_in(key,
  777))`` bitwise on the reference's own per-step keys;
* ``WalkEngine.run`` with ``method="random"`` / ``"degree"`` equals the
  reference's: paths, regime fractions, fallbacks and live steps bitwise,
  with a lowered ``degree_threshold`` so both regimes serve lanes and a
  starved eRJS budget so some lanes fall back;
* the registry, the config default and the staged-only plan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, random_keys  # noqa: F401
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch.core import EngineConfig, WalkEngine, available_samplers
from repro_torch.core.samplers import Estimates, random_policy
from repro_torch.graphs import power_law_graph
from repro_torch.launch import walk as walk_cli
from repro_torch.walks import make_workload

V, STEPS = 300, 8
CASES = [("random", "node2vec"), ("random", "deepwalk"),
         ("degree", "node2vec"), ("degree", "metapath")]


def _kw(method):
    return dict(method=method, tile=16, degree_threshold=12, rjs_trials=2,
                rjs_max_rounds=1)


@pytest.fixture(scope="module")
def graphs():
    return ref_power_law(V, 8, seed=3), power_law_graph(V, 8, seed=3)


def test_random_policy_coin_matches_bernoulli():
    kd = random_keys(4000, seed=1)
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(
        jax.random.fold_in(jax.random.wrap_key_data(k), 777)))(
            jnp.asarray(kd)))
    bound = torch.ones(kd.shape[0])
    est = Estimates(bound_max=bound, sum_est=bound)
    active = torch.ones(kd.shape[0], dtype=torch.bool)
    got = random_policy(None, None, est, None, active,
                        torch.from_numpy(kd.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.45 < want.mean() < 0.55
    # lanes without a bound never go to eRJS
    est = Estimates(bound_max=torch.zeros_like(bound), sum_est=bound)
    assert not random_policy(None, None, est, None, active,
                             torch.from_numpy(kd.astype(np.int64))).any()


@pytest.mark.parametrize("method,name", CASES)
def test_selector_runs_match_reference(graphs, method, name):
    g, pg = graphs
    ref = RefEngine(g, ref_make_workload(name), RefConfig(**_kw(method))).run(
        np.arange(V), num_steps=STEPS)
    got = WalkEngine(pg, make_workload(name), EngineConfig(
        device="cpu", **_kw(method))).run(np.arange(V), num_steps=STEPS)
    np.testing.assert_array_equal(ref.paths, got.paths)
    for f in ("frac_rjs", "rjs_fallbacks", "live_steps", "frac_precomp"):
        assert getattr(ref, f) == getattr(got, f), f
    # both regimes served lanes, and some eRJS lanes fell back
    assert 0.0 < got.frac_rjs < 1.0 and got.rjs_fallbacks > 0


def test_registry_config_and_plan(graphs):
    assert {"random", "degree"} <= set(available_samplers())
    assert EngineConfig(device="cpu").degree_threshold == \
        RefConfig().degree_threshold == 1024
    _, pg = graphs
    for method in ("random", "degree"):
        eng = WalkEngine(pg, make_workload("deepwalk"), EngineConfig(
            device="cpu", method=method, step_exec="fused"))
        assert eng.step_exec_resolved == "staged"
        assert eng.precomp is None


def test_degree_threshold_moves_the_split(graphs):
    """At the default threshold no row of this graph reaches eRJS."""
    _, pg = graphs
    res = {t: WalkEngine(pg, make_workload("node2vec"), EngineConfig(
        device="cpu", method="degree", degree_threshold=t)).run(
            np.arange(V), num_steps=4) for t in (1024, 4)}
    assert res[1024].frac_rjs == 0.0 and res[4].frac_rjs > 0.5


def test_cli_runs_a_selector_on_cpu(capsys):
    walk_cli.main(["--nodes", "200", "--queries", "20", "--steps", "4",
                   "--method", "random", "--device", "cpu"])
    assert "frac_rjs" in capsys.readouterr().out
