"""The table-draw switch ``EngineConfig.precomp_exec`` in the port (the
reference's ``precomp_exec``: "flat" is its "jnp", "aligned" its
"pallas"):

* "aligned" runs equal "flat" runs, paths and telemetry, under
  ``its_precomp`` and ``alias_precomp`` (stale rows included) and under
  ``adaptive``'s ITS regime, and both equal the reference's runs under
  ``precomp_exec="jnp"``; one tiny case equals the reference under
  ``"pallas"`` (its Pallas kernels in interpret mode);
* ``PrecompTables.with_aligned`` equals the reference's arrays, ITS-only
  tables get their CDF stream, and the engine attaches the streams only
  under "aligned" (at build, through the ``precomp`` setter, and on
  tables another engine baked, ``WalkEngine(..., precomp=)``);
* a missing stream raises, the choice is validated, and the CLI's
  ``--precomp-exec`` runs.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, to_port_graph  # noqa: F401
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import PRECOMP_EXEC_CHOICES, EngineConfig, WalkEngine
from repro_torch.core.types import WalkerState
from repro_torch.kernels.prng import key_data
from repro_torch.launch import walk as walk_cli
from repro_torch.walks import make_workload

V = 300
TELEMETRY = ("live_steps", "frac_rjs", "frac_precomp", "frac_stale",
             "rjs_fallbacks")
STALE_ROWS = np.arange(1, V, 3)


@pytest.fixture(scope="module")
def graphs():
    g = ref_power_law(V, 8, seed=4)
    return g, to_port_graph(g)


def _port_engine(pg, method, exec_, name="deepwalk"):
    return WalkEngine(pg, make_workload(name), EngineConfig(
        method=method, tile=16, device="cpu", precomp_exec=exec_))


def _with_stale(eng):
    invalid = eng.precomp.invalid.clone()
    invalid[torch.from_numpy(STALE_ROWS)] = True
    eng.precomp = dataclasses.replace(eng.precomp, invalid=invalid)


def _same(a, b, what):
    np.testing.assert_array_equal(a.paths, b.paths, err_msg=what)
    for f in TELEMETRY:
        assert getattr(a, f) == getattr(b, f), (what, f)


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("method", ["its_precomp", "alias_precomp",
                                    "adaptive"])
def test_aligned_equals_flat_and_reference(graphs, method, stale):
    g, pg = graphs
    starts = np.arange(V)
    run = dict(num_steps=7, batch=64, epoch_len=3)
    ref_eng = RefEngine(g, ref_make_workload("deepwalk"), RefConfig(
        method=method, tile=16, precomp_exec="jnp"))
    if stale:
        ref_eng.precomp = ref_eng.precomp.invalidate(STALE_ROWS)
    ref = ref_eng.run(starts, key=jax.random.key(2), **run)
    res = {}
    for exec_ in ("flat", "aligned"):
        eng = _port_engine(pg, method, exec_)
        if stale:
            _with_stale(eng)
        res[exec_] = eng.run(starts, key=key_data(2), **run)
    _same(res["flat"], res["aligned"], f"{method}: aligned vs flat")
    _same(ref, res["aligned"], f"{method}: reference vs port")
    assert res["aligned"].frac_precomp > 0
    assert (res["aligned"].frac_stale > 0) == stale


@pytest.mark.parametrize("method", ["its_precomp", "alias_precomp"])
def test_equals_the_reference_under_pallas(method):
    """One tiny case against the reference's Pallas draw kernels (interpret
    mode off the TPU)."""
    g = ref_power_law(40, 4, seed=1)
    ref = RefEngine(g, ref_make_workload("deepwalk"), RefConfig(
        method=method, tile=16, precomp_exec="pallas")).run(
        np.arange(12), num_steps=3, key=jax.random.key(1))
    got = _port_engine(to_port_graph(g), method, "aligned").run(
        np.arange(12), num_steps=3, key=key_data(1))
    _same(ref, got, method)


def test_with_aligned_equals_the_reference(graphs):
    g, pg = graphs
    ref_eng = RefEngine(g, ref_make_workload("deepwalk"), RefConfig(
        method="alias_precomp", tile=16, precomp_exec="pallas"))
    rt = ref_eng.precomp
    flat = interop.tables_from_arrays(
        np.asarray(rt.cdf), np.asarray(rt.total), np.asarray(rt.invalid),
        alias_off=np.asarray(rt.alias_off),
        alias_prob=np.asarray(rt.alias_prob))
    got = flat.with_aligned(pg.indptr)
    assert flat.arow0 is None and got is not flat
    for f in ("cdf2d", "prob2d", "alias2d", "arow0"):
        np.testing.assert_array_equal(np.asarray(getattr(rt, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    # ITS-only tables (what its_precomp and adaptive build): the CDF stream
    its_only = dataclasses.replace(flat, alias_off=None, alias_prob=None)
    part = its_only.with_aligned(pg.indptr)
    assert part.prob2d is None and part.alias2d is None
    assert torch.equal(part.cdf2d, got.cdf2d)
    assert torch.equal(part.arow0, got.arow0)


def test_streams_only_where_aligned(graphs):
    """The engine attaches the aligned streams only when the draws resolve
    to "aligned"; the ``precomp`` setter lays them out for tables that
    come without them."""
    _, pg = graphs
    assert PRECOMP_EXEC_CHOICES == ("auto", "flat", "aligned")
    for exec_ in ("auto", "flat"):
        assert _port_engine(pg, "its_precomp", exec_).precomp.cdf2d is None
    eng = _port_engine(pg, "alias_precomp", "aligned")
    t = eng.precomp
    assert all(getattr(t, f) is not None
               for f in ("cdf2d", "prob2d", "alias2d", "arow0"))
    eng.precomp = dataclasses.replace(t, cdf2d=None, prob2d=None,
                                      alias2d=None, arow0=None)
    assert torch.equal(eng.precomp.alias2d, t.alias2d)
    its = _port_engine(pg, "adaptive", "aligned").precomp
    assert its.cdf2d is not None and its.prob2d is None


def test_an_engine_reuses_baked_tables(graphs):
    """``WalkEngine(..., precomp=tables)`` takes another engine's tables in
    place of a build (the aligned streams laid out as the setter lays
    them) and walks as that engine does."""
    _, pg = graphs
    flat = _port_engine(pg, "alias_precomp", "flat")
    reuse = WalkEngine(pg, make_workload("deepwalk"), EngineConfig(
        method="alias_precomp", tile=16, device="cpu",
        precomp_exec="aligned"), precomp=flat.precomp)
    assert reuse.precomp.alias_off is flat.precomp.alias_off
    assert flat.precomp.alias2d is None and reuse.precomp.alias2d is not None
    _same(flat.run(np.arange(V), num_steps=5, key=key_data(6)),
          reuse.run(np.arange(V), num_steps=5, key=key_data(6)), "reuse")


@pytest.mark.parametrize("method,kind", [("its_precomp", "its"),
                                         ("alias_precomp", "alias")])
def test_missing_stream_raises(graphs, method, kind):
    """Under "aligned" a draw never falls back to the flat entries."""
    from repro_torch.core.samplers import precomp_table_select

    _, pg = graphs
    eng = _port_engine(pg, method, "aligned")
    field = "cdf2d" if kind == "its" else "alias2d"
    ctx = dataclasses.replace(eng.sampler_ctx, precomp=dataclasses.replace(
        eng.precomp, **{field: None}))
    state = WalkerState.create(torch.arange(4), key_data(0))
    with pytest.raises(RuntimeError, match=rf"aligned.*{field}"):
        precomp_table_select(ctx, state, state.stream_keys(), state.alive,
                             kind=kind)


def test_choice_is_validated():
    with pytest.raises(ValueError, match="precomp_exec"):
        EngineConfig(precomp_exec="pallas")


def test_cli_flag(capsys):
    walk_cli.main(["--nodes", "200", "--queries", "40", "--steps", "5",
                   "--workload", "deepwalk", "--method", "alias_precomp",
                   "--precomp-exec", "aligned", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "precomp_exec=aligned" in out and "frac_precomp=1.00" in out
    walk_cli.main(["--nodes", "200", "--queries", "40", "--steps", "5",
                   "--method", "interleaved", "--device", "cpu"])
    assert "40 queries" in capsys.readouterr().out
