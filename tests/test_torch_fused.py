"""Port parity, part 6: the fused epoch (``step_exec="fused"``, kernel K4).

The reference's own fused ervs/erjs cells are red on jax 0.9.0 (ROADMAP
queue 3), so the port's fused path is held against the reference's
*staged* scan:

* flag words reduce to the reference's ``StepStats``;
* ``fuse_report``, ``Sampler.fused_kind`` and ``step_exec_resolved``
  agree with the reference for every (sampler × program × step_exec)
  cell of the port, and ``_bake_bmax`` bitwise;
* fused runs (K4's plain version) give the reference's staged paths and
  all five telemetry counters bit for bit, for deepwalk × ervs / erjs /
  its_precomp / alias_precomp at tiles 32 and 256, with refills and an
  odd ``epoch_len``; with stale rows made by the reference's own
  ``update_graph`` (the bitmap carried over by ``interop``); with forced
  eRJS fallbacks;
* ``--step-exec`` on the CLI.

K4 itself runs only on the card (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, one_torch_thread  # noqa: F401
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.core import flexi_compiler as ref_fc
from repro.core.samplers import get_sampler as ref_get_sampler
from repro.core.types import StepStats as RefStepStats
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import EngineConfig, WalkEngine, available_samplers
from repro_torch.core import flexi_compiler as fc
from repro_torch.core.samplers import get_sampler
from repro_torch.core.types import StepStats, WalkerState
from repro_torch.graphs import power_law_graph
from repro_torch.kernels import build, megastep
from repro_torch.kernels.prng import fold_in, key_data
from repro_torch.launch import walk as walk_cli
from repro_torch.walks import make_workload

V, STEPS, BATCH, EPOCH = 300, 9, 128, 5  # refills, odd epoch length
METHODS = ["ervs", "erjs", "its_precomp", "alias_precomp"]
PROGRAMS = [("node2vec", True), ("node2vec", False), ("deepwalk", True),
            ("deepwalk", False)]
TELEMETRY = ("frac_rjs", "frac_precomp", "frac_stale", "rjs_fallbacks",
             "live_steps")


@pytest.fixture(scope="module")
def graphs():
    g = ref_power_law(V, 8, seed=3)
    pg = power_law_graph(V, 8, seed=3)
    assert np.array_equal(np.asarray(g.indices), pg.indices.numpy())
    return g, pg


def _run_ref(g, method, **kw):
    eng = RefEngine(g, ref_make_workload("deepwalk"),
                    RefConfig(method=method, step_exec="staged", **kw))
    return eng, eng.run(np.arange(V), num_steps=STEPS, batch=BATCH,
                        epoch_len=EPOCH)


@pytest.fixture(scope="module")
def ref_staged(graphs):
    """(engine, staged run) of the reference per (method, tile), made once
    per module: its compiles dominate this file's time.  No rows are
    rebuilt (``rebuild_budget=0``), which changes nothing until a test
    marks rows stale on the engine — after its clean run was taken."""
    cache = {}

    def get(method, tile):
        if (method, tile) not in cache:
            cache[method, tile] = _run_ref(graphs[0], method, tile=tile,
                                           rebuild_budget=0)
        return cache[method, tile]
    return get


def _port_engine(pg, method, step_exec="fused", **kw):
    eng = WalkEngine(pg, make_workload("deepwalk"),
                     EngineConfig(method=method, step_exec=step_exec,
                                  device="cpu", **kw))
    assert eng.step_exec_resolved == step_exec, eng.fuse.reasons
    return eng


def _assert_same(ref, got):
    assert np.array_equal(ref.paths, got.paths)
    for f in TELEMETRY:
        assert getattr(ref, f) == getattr(got, f), f


def test_flag_bits_reduce_like_the_reference():
    flags = np.random.default_rng(0).integers(0, 32, size=(50, 7),
                                              dtype=np.int32)
    want = RefStepStats.from_flag_bits(flags)
    got = StepStats.from_flag_bits(torch.from_numpy(flags))
    for f in ("live", "rjs_served", "fallbacks", "precomp_served",
              "stale_served"):
        assert np.array_equal(np.asarray(getattr(want, f)),
                              getattr(got, f).numpy()), f
    assert got.host_totals() == want.host_totals()


@pytest.mark.parametrize("name,weighted", PROGRAMS)
def test_fuse_report_matches_reference(name, weighted):
    want = ref_fc.fuse_report(ref_make_workload(name, weighted=weighted))
    got = fc.fuse_report(make_workload(name, weighted=weighted))
    assert (got.weight_fusable, got.hooks_fusable, got.bound_node_local,
            got.fusable) == (want.weight_fusable, want.hooks_fusable,
                             want.bound_node_local, want.fusable)
    assert bool(got.reasons) == bool(want.reasons)


def test_fused_kind_matches_reference():
    for name in available_samplers():
        for usable in (True, False):
            for has_precomp in (True, False):
                kw = dict(usable=usable, has_precomp=has_precomp)
                assert get_sampler(name).fused_kind(**kw) == \
                    ref_get_sampler(name).fused_kind(**kw), (name, kw)


@pytest.mark.parametrize("step_exec", ["auto", "fused", "staged"])
def test_step_exec_resolved_matches_reference(graphs, step_exec):
    """Every cell of the port, plus a tile outside the kernel geometry; on
    the CPU "auto" resolves staged in both packages."""
    g, pg = graphs
    cells = [(m, p, w, 32) for m in available_samplers()
             for p, w in PROGRAMS] + [("ervs", "deepwalk", True, 6)]
    for method, name, weighted, tile in cells:
        kw = dict(method=method, step_exec=step_exec, tile=tile)
        want = RefEngine(g, ref_make_workload(name, weighted=weighted),
                         RefConfig(**kw)).step_exec_resolved
        got = WalkEngine(pg, make_workload(name, weighted=weighted),
                         EngineConfig(device="cpu", **kw)).step_exec_resolved
        assert got == want, (method, name, weighted, tile)


@pytest.mark.parametrize("weighted", [True, False])
def test_bake_bmax_matches_reference(graphs, weighted):
    g, pg = graphs
    ref = RefEngine(g, ref_make_workload("deepwalk", weighted=weighted),
                    RefConfig(method="erjs", step_exec="staged"))
    eng = WalkEngine(pg, make_workload("deepwalk", weighted=weighted),
                     EngineConfig(method="erjs", step_exec="fused",
                                  device="cpu"))
    want = np.asarray(ref._bake_bmax(), np.float32)
    got = eng._bake_bmax().numpy()
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
    assert torch.equal(eng._fused_bmax, eng._bake_bmax())


@pytest.mark.parametrize("tile", [32, 256])
@pytest.mark.parametrize("method", METHODS)
def test_fused_runs_match_reference_staged(graphs, ref_staged, method,
                                           tile):
    _, pg = graphs
    _, ref = ref_staged(method, tile)
    got = _port_engine(pg, method, tile=tile).run(
        np.arange(V), num_steps=STEPS, batch=BATCH, epoch_len=EPOCH)
    _assert_same(ref, got)


@pytest.mark.parametrize("method", ["its_precomp", "alias_precomp"])
def test_stale_rows_take_the_reservoir(graphs, ref_staged, method):
    """Every third row marked stale by the reference's ``update_graph``
    (same weights, no rebuilds); the port gets the same bitmap."""
    g, pg = graphs
    rows = np.arange(0, V, 3)
    ref_eng, _ = ref_staged(method, 32)
    ref_eng.update_graph(g, invalidated=rows)
    ref = ref_eng.run(np.arange(V), num_steps=STEPS, batch=BATCH,
                      epoch_len=EPOCH)
    t = ref_eng.precomp
    eng = _port_engine(pg, method, tile=32)
    eng.precomp = interop.tables_from_arrays(
        t.cdf, t.total, t.invalid, alias_off=t.alias_off,
        alias_prob=t.alias_prob)
    assert eng.precomp.invalid.nonzero().squeeze(1).tolist() == rows.tolist()
    got = eng.run(np.arange(V), num_steps=STEPS, batch=BATCH,
                  epoch_len=EPOCH)
    _assert_same(ref, got)
    assert got.frac_stale > 0 and got.frac_precomp > 0


def test_forced_erjs_fallbacks(graphs):
    g, pg = graphs
    kw = dict(tile=32, rjs_trials=1, rjs_max_rounds=1)
    _, ref = _run_ref(g, "erjs", **kw)
    got = _port_engine(pg, "erjs", **kw).run(
        np.arange(V), num_steps=STEPS, batch=BATCH, epoch_len=EPOCH)
    _assert_same(ref, got)
    assert got.rjs_fallbacks > 0


def test_fused_epoch_refuses_what_it_cannot_run(graphs):
    _, pg = graphs
    W = 4
    state = WalkerState(
        cur=torch.arange(W), prev=torch.full((W,), -1),
        step=torch.zeros(W, dtype=torch.int64),
        alive=torch.ones(W, dtype=torch.bool),
        rng=torch.zeros((W, 2), dtype=torch.int64))
    kw = dict(tile=32, rjs_trials=8, rjs_max_rounds=16, epoch_len=2,
              num_steps=4)
    n2v = make_workload("node2vec")
    with pytest.raises(ValueError, match="cannot run fused"):
        megastep.fused_epoch(pg, n2v, n2v.params(), state, kind="reservoir",
                             **kw)
    dw = make_workload("deepwalk")
    with pytest.raises(ValueError, match="not one of"):
        megastep.fused_epoch(pg, dw, (), state, kind="jump", **kw)
    with pytest.raises(ValueError, match="bmax"):
        megastep.fused_epoch(pg, dw, (), state, kind="rejection", **kw)
    with pytest.raises(ValueError, match="tables"):
        megastep.fused_epoch(pg, dw, (), state, kind="precomp_its", **kw)
    build.reset_launches()
    out, emitted, flags = megastep.fused_epoch(pg, dw, (), state,
                                               kind="reservoir", **kw)
    assert emitted.shape == flags.shape == (W, 2)
    assert sum(build.LAUNCHES.values()) == 0  # plain version on the CPU


@pytest.mark.cuda
def test_fused_epoch_kernel_matches_plain(cuda_device):

    g = power_law_graph(3000, 10, seed=7)
    for method, kw in (("ervs", {}), ("erjs", dict(rjs_trials=1,
                                                   rjs_max_rounds=1)),
                       ("its_precomp", {}), ("alias_precomp", {})):
        eng = WalkEngine(g, make_workload("deepwalk"), EngineConfig(
            method=method, step_exec="fused", **kw))
        tables = eng.precomp
        if tables is not None:  # every third row stale
            inv = torch.zeros_like(tables.invalid)
            inv[::3] = True
            eng.precomp = type(tables)(tables.cdf, tables.total,
                                       tables.alias_off, tables.alias_prob,
                                       inv)
        W = 4096
        dev = eng.device
        state = WalkerState(
            cur=torch.randint(0, g.num_nodes, (W,), device=dev),
            prev=torch.full((W,), -1, device=dev),
            step=torch.zeros(W, dtype=torch.int64, device=dev),
            alive=torch.ones(W, dtype=torch.bool, device=dev),
            rng=fold_in(key_data(0).to(dev).expand(W, 2),
                        torch.arange(W, device=dev)))
        args = dict(kind=eng._fused_kind, tile=eng.config.tile,
                    rjs_trials=eng.config.rjs_trials,
                    rjs_max_rounds=eng.config.rjs_max_rounds, epoch_len=16,
                    num_steps=80, bmax=eng._fused_bmax, tables=eng.precomp)
        got = megastep.fused_epoch(eng.graph, eng.workload, (), state, **args)
        want = megastep.fused_epoch_plain(eng.graph, eng.workload, (), state,
                                          **args)
        torch.cuda.synchronize()
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a, b), method
        for f in ("cur", "prev", "step", "alive"):
            assert torch.equal(getattr(got[0], f), getattr(want[0], f))


@pytest.mark.parametrize("step_exec", ["fused", "staged"])
def test_cli_step_exec(capsys, step_exec):
    walk_cli.main(["--nodes", "300", "--queries", "40", "--steps", "5",
                   "--device", "cpu", "--workload", "deepwalk",
                   "--method", "alias_precomp", "--batch", "16",
                   "--epoch-len", "3", "--step-exec", step_exec])
    out = capsys.readouterr().out
    assert f"step_exec={step_exec}" in out and "frac_precomp=1.00" in out
