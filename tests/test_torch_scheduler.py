"""The scheduler's library surface in the port (``repro/core/runtime.py``'s
``EpochScheduler`` queries, ``kill``, pinned tables, ``scheduler()`` and
``walk_batch``; ``tests/test_sampling.py``'s ``walk_batch`` case):

* one script of ``admit`` / ``kill`` / ``run_epoch`` calls, driven
  against the reference's ``eng.scheduler()`` and the port's, gives equal
  ``paths``, ``completed``, ``steps_taken``, ``walker_steps``,
  ``occupancy`` and ``in_flight`` after every call;
* a scheduler serves from the tables pinned at its construction after a
  ``precomp`` swap with stale rows, and ``track_tables=True`` adopts the
  swap, each as the reference's does;
* ``walk_batch`` equals the reference's staged ``walk_batch`` (paths and
  per-step counters) and ``run()``, and the port's fused path equals its
  staged one;
* ``scheduler()`` validates as the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, to_port_graph  # noqa: F401
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.graphs import random_graph as ref_random_graph
from repro.walks import make_workload as ref_make_workload
from repro_torch.core import EngineConfig, WalkEngine
from repro_torch.core.types import StepStats
from repro_torch.kernels.prng import key_data
from repro_torch.walks import make_workload

V = 200
FIELDS = [f.name for f in dataclasses.fields(StepStats)]


@pytest.fixture(scope="module")
def graphs():
    g = ref_random_graph(V, 8, seed=1)
    return g, to_port_graph(g)


def _engines(graphs, name, **kw):
    g, pg = graphs
    return (RefEngine(g, ref_make_workload(name), RefConfig(**kw)),
            WalkEngine(pg, make_workload(name), EngineConfig(device="cpu",
                                                             **kw)))


SCRIPT_CASES = {
    "node2vec/adaptive": ("node2vec", dict(method="adaptive", tile=16)),
    "deepwalk/its_precomp": ("deepwalk", dict(method="its_precomp",
                                              tile=16)),
    "node2vec/interleaved": ("node2vec", dict(method="interleaved",
                                              tile=8)),
}


@pytest.mark.parametrize("case", list(SCRIPT_CASES))
def test_admit_kill_script_matches_reference(graphs, case):
    name, kw = SCRIPT_CASES[case]
    ref_eng, eng = _engines(graphs, name, **kw)
    scheds = (ref_eng.scheduler(num_steps=7, key=jax.random.key(8), slots=5,
                                epoch_len=2),
              eng.scheduler(num_steps=7, key=key_data(8), slots=5,
                            epoch_len=2))
    starts = (np.arange(17) * 11) % V
    head, epoch, killed_any = 0, 0, False
    while head < starts.size or scheds[0].busy:
        free = [s.free_slots() for s in scheds]
        np.testing.assert_array_equal(*free)
        n = min(free[0].size, starts.size - head, 1 + epoch % 3)
        if n:
            got = [s.admit(np.arange(head, head + n),
                           starts[head:head + n]) for s in scheds]
            assert got[0] == got[1] == n
            head += n
        if epoch in (2, 5):  # kill some in flight, and one that is not
            fl = scheds[0].in_flight()
            ids = np.concatenate([fl[::2], [999]])
            out = [s.kill(ids) for s in scheds]
            np.testing.assert_array_equal(*out)
            assert 999 not in out[1] and out[1].size
            killed_any = True
        for s in scheds:
            assert s.occupancy == scheds[0].occupancy
            np.testing.assert_array_equal(s.in_flight(),
                                          scheds[0].in_flight())
        reps = [s.run_epoch() for s in scheds]
        for f in ("completed", "steps_taken"):
            np.testing.assert_array_equal(getattr(reps[0], f),
                                          getattr(reps[1], f), err_msg=f)
        assert reps[0].walker_steps == reps[1].walker_steps
        assert reps[0].occupied == reps[1].occupied
        assert reps[0].stats == reps[1].stats
        np.testing.assert_array_equal(scheds[0].paths, scheds[1].paths)
        epoch += 1
    assert killed_any and scheds[1].totals == scheds[0].totals
    assert scheds[1].occupancy == 0 and scheds[1].in_flight().size == 0


def test_walker_steps_sum_to_the_live_total(graphs):
    """Σ ``walker_steps`` over a scheduler's epochs is its ``live`` total,
    and a run of the same queries gives the same paths."""
    _, eng = _engines(graphs, "node2vec", method="adaptive", tile=16)
    s = eng.scheduler(num_steps=6, key=key_data(3), slots=V)
    s.admit(np.arange(V), np.arange(V))
    total = 0
    while s.busy:
        total += s.run_epoch().walker_steps
    assert total == s.totals["live"] > 0
    res = eng.run(np.arange(V), num_steps=6, key=key_data(3))
    np.testing.assert_array_equal(s.paths, res.paths)


def _stale(ref_tables, port_tables, every: int = 3):
    """Both packages' tables with every ``every``-th row stale."""
    rows = np.arange(0, V, every)
    invalid = port_tables.invalid.clone()
    invalid[torch.from_numpy(rows)] = True
    return (ref_tables.invalidate(rows),
            dataclasses.replace(port_tables, invalid=invalid))


def _drive(sched, starts, swap=None):
    """Admit every query at once, run one epoch, call ``swap`` (if any),
    then run to the end."""
    sched.admit(np.arange(starts.size), starts)
    sched.run_epoch()
    if swap is not None:
        swap()
    while sched.busy:
        sched.run_epoch()
    return sched


@pytest.mark.parametrize("method", ["its_precomp", "alias_precomp"])
def test_pinned_tables_survive_a_precomp_swap(graphs, method):
    """After ``engine.precomp`` takes tables with stale rows, a scheduler
    built before the swap keeps drawing from the tables it pinned (no
    stale lane), and one with ``track_tables=True`` adopts the swap at
    its next epoch; both equal the reference's schedulers."""
    ref_eng, eng = _engines(graphs, "deepwalk", method=method, tile=16)
    ref_tables, tables = ref_eng.precomp, eng.precomp
    ref_stale, stale = _stale(ref_tables, tables)
    starts = np.arange(V)
    out = {}
    for track in (False, True):
        ref_eng.precomp, eng.precomp = ref_tables, tables

        def swap():
            ref_eng.precomp, eng.precomp = ref_stale, stale

        kw = dict(num_steps=6, slots=V, epoch_len=2, track_tables=track)
        ref_s = ref_eng.scheduler(key=jax.random.key(5), **kw)
        port_s = eng.scheduler(key=key_data(5), **kw)
        _drive(ref_s, starts, swap)
        ref_eng.precomp, eng.precomp = ref_tables, tables
        _drive(port_s, starts, swap)
        np.testing.assert_array_equal(ref_s.paths, port_s.paths)
        assert ref_s.totals == port_s.totals, track
        out[track] = port_s
    assert out[False].totals["stale_served"] == 0
    assert out[True].totals["stale_served"] > 0
    eng.precomp = tables
    fresh = eng.run(starts, num_steps=6, key=key_data(5))
    np.testing.assert_array_equal(fresh.paths, out[False].paths)


BATCH_CASES = [("deepwalk", "ervs"), ("deepwalk", "its_precomp"),
               ("deepwalk", "alias_precomp"), ("deepwalk", "erjs"),
               ("node2vec", "interleaved"), ("ppr_nibble", "ervs")]


@pytest.mark.parametrize("name,method", BATCH_CASES)
def test_walk_batch_matches_reference_and_fused(graphs, name, method):
    """``walk_batch``: walker i serves query i, so its paths are ``run()``'s
    with queries in slot order, and equal the reference's staged
    ``walk_batch`` with its per-step counters; the fused path, where the
    cell has one, gives the staged bits."""
    g, pg = graphs
    starts = (np.arange(24) * 7) % V
    ref_eng = RefEngine(g, ref_make_workload(name), RefConfig(
        method=method, tile=16, step_exec="staged"))
    want_paths, want_stats = ref_eng.walk_batch(
        starts.astype(np.int32), jax.random.key(9), 6)
    got = {}
    for ex in ("staged", "fused"):
        eng = WalkEngine(pg, make_workload(name), EngineConfig(
            method=method, tile=16, device="cpu", step_exec=ex))
        paths, stats = eng.walk_batch(starts, key_data(9), 6)
        assert paths.shape == (24, 6) and paths.dtype == torch.int32
        got[ex] = (eng.step_exec_resolved, paths, stats)
    paths, stats = got["staged"][1:]
    np.testing.assert_array_equal(np.asarray(want_paths), paths.numpy())
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want_stats, f)),
                                      getattr(stats, f).numpy(), err_msg=f)
    ex, fpaths, fstats = got["fused"]
    # interleaved has no fused regime (the reference's plan too)
    assert ex == ("staged" if method == "interleaved" else "fused")
    assert torch.equal(fpaths, paths)
    for f in FIELDS:
        assert torch.equal(getattr(fstats, f), getattr(stats, f)), f
    res = eng.run(starts, num_steps=6, key=key_data(9))
    np.testing.assert_array_equal(res.paths[:, 1:], paths.numpy())
    assert int(stats.live.sum()) == res.live_steps


def test_scheduler_validates_as_the_reference():
    g = ref_random_graph(30, 4, seed=0)
    eng = WalkEngine(to_port_graph(g), make_workload("deepwalk"),
                     EngineConfig(method="ervs", device="cpu"))
    with pytest.raises(ValueError, match="num_steps"):
        eng.scheduler(num_steps=0)
    with pytest.raises(ValueError, match="slots"):
        eng.scheduler(num_steps=4, slots=0)
    s = eng.scheduler(num_steps=40, slots=3)
    assert (s.W, s.T, s.num_steps) == (3, 16, 40)
    assert eng.scheduler(num_steps=5, epoch_len=9).T == 5
    with pytest.raises(ValueError, match="num_steps"):
        eng.walk_batch(np.arange(3), key_data(0), 0)
