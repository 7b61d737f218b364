"""The deprecated ``Workload`` protocol in the port (``tests/
test_programs.py``'s adapter cases): the constructor warns,
``from_workload`` is the identity on programs and adapts a duck-typed
legacy object, and the six stateless registry programs give the same
paths and telemetry natively, as a ``Workload`` and through
``from_workload`` under ``ervs``, ``adaptive`` and ``interleaved``,
equal to the reference's native runs.
"""
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
from repro_torch.core import flexi_compiler as fc
from repro_torch.core.types import WalkProgram, Workload, from_workload
from repro_torch.kernels.prng import key_data
from repro_torch.walks import make_workload

LEGACY_NAMES = ["node2vec", "node2vec_unweighted", "metapath",
                "metapath_unweighted", "2ndpr", "deepwalk"]
TELEMETRY = ("live_steps", "frac_rjs", "frac_precomp", "rjs_fallbacks")


def legacy_clone(program: WalkProgram) -> Workload:
    """The stateless program as a genuine legacy ``Workload`` (two-argument
    ``get_weight``) sharing its weight, without declarations."""
    gw3 = program.get_weight
    with pytest.warns(DeprecationWarning):
        return Workload(
            name=program.name, init=program.init,
            get_weight=lambda ctx, params: gw3(ctx, params, None),
            needs_dist=program.needs_dist,
            needs_labels=program.needs_labels,
            num_labels=program.num_labels, weighted=program.weighted,
            walk_len=program.walk_len)


def test_workload_constructor_warns():
    with pytest.warns(DeprecationWarning, match="WalkProgram"):
        Workload(name="w", init=lambda: (), get_weight=lambda c, p: c.h)


def test_from_workload_is_identity_for_programs():
    prog = make_workload("deepwalk")
    assert from_workload(prog) is prog
    legacy = legacy_clone(prog)
    adapted = from_workload(legacy)
    assert adapted is not legacy and type(adapted) is WalkProgram
    assert fc.trace_weight(adapted)[0].code == \
        fc.trace_weight(legacy)[0].code


@pytest.fixture(scope="module")
def graphs():
    g = ref_random_graph(150, 6, seed=2)
    return g, to_port_graph(g)


def test_duck_typed_legacy_object_accepted(graphs):
    """The engine takes anything with the legacy attributes, adapted."""
    class Legacy:
        name = "duck"
        needs_dist = needs_labels = False
        num_labels = 1
        weighted = True
        walk_len = 10

        @staticmethod
        def init():
            return ()

        @staticmethod
        def get_weight(ctx, params):
            return ctx.h

    _, pg = graphs
    eng = WalkEngine(pg, Legacy(),
                     EngineConfig(method="ervs", tile=64, device="cpu"))
    res = eng.run(np.arange(8), num_steps=4)
    assert res.paths.shape == (8, 5) and (res.paths[:, 1:] >= 0).all()
    assert eng.compiled.flag == "PER_STEP"


@pytest.mark.parametrize("method", ["ervs", "adaptive", "interleaved"])
@pytest.mark.parametrize("name", LEGACY_NAMES)
def test_bit_identity_through_adapter(graphs, name, method):
    """Paths and telemetry natively, as a ``Workload`` and through
    ``from_workload``, all equal to the reference's native run."""
    g, pg = graphs
    ref = RefEngine(g, ref_make_workload(name),
                    RefConfig(method=method, tile=64)).run(
        np.arange(16), num_steps=5, key=jax.random.key(7), batch=5,
        epoch_len=2)
    native = make_workload(name)
    legacy = legacy_clone(native)
    for wl in (native, legacy, from_workload(legacy)):
        eng = WalkEngine(pg, wl, EngineConfig(method=method, tile=64,
                                              device="cpu"))
        res = eng.run(np.arange(16), num_steps=5, key=key_data(7), batch=5,
                      epoch_len=2)
        np.testing.assert_array_equal(ref.paths, res.paths,
                                      err_msg=f"{name}/{method}")
        for f in TELEMETRY:
            assert getattr(ref, f) == getattr(res, f), (name, method, f)


def test_legacy_weight_on_a_block():
    """The adapter's weight on a [W, k] block is the program's."""
    native = make_workload("node2vec")
    legacy = legacy_clone(native)
    from repro_torch.core.types import EdgeCtx

    rng = np.random.default_rng(3)
    t = lambda x: torch.from_numpy(np.asarray(x))
    ctx = EdgeCtx(h=t(rng.random((4, 6)).astype(np.float32)),
                  label=t(rng.integers(0, 5, (4, 6))),
                  dist=t(rng.integers(0, 3, (4, 6))),
                  nbr=t(rng.integers(0, 99, (4, 6))),
                  **{f: t(rng.integers(0, 9, (4, 6))) for f in
                     ("deg_cur", "deg_prev", "cur", "prev", "step")})
    p = native.params()
    want = native.edge_weight(ctx, p, None)
    for wl in (legacy, from_workload(legacy)):
        assert torch.equal(wl.edge_weight(ctx, p, None), want)
