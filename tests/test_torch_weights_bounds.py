"""Port parity, part 2: the weight rules and the Flexi-Compiler facts.

Bitwise against the reference on the same inputs: the weights
``eval_weights`` gives both programs on tile and single-edge contexts, the
declared bound and Eq. 12 sum against the reference compiler's
``bound_fn`` / ``sum_fn``, the flag and the static proof, and the cost
model's regime decisions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, to_port_graph  # noqa: F401
from repro.core import BoundInputs as RefBoundInputs
from repro.core import CostModel as RefCostModel
from repro.core import analyze as ref_analyze
from repro.core import is_static as ref_is_static
from repro.core.ctxutil import eval_weights as ref_eval_weights
from repro.core.ctxutil import single_edge_ctx as ref_single_edge_ctx
from repro.core.ctxutil import tile_ctx as ref_tile_ctx
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch.core import BoundInputs, CostModel, analyze, is_static
from repro_torch.core.ctxutil import eval_weights, single_edge_ctx, tile_ctx
from repro_torch.kernels.ervs import kernel_rule
from repro_torch.walks import make_workload

PROGRAMS = [
    ("node2vec", dict()),
    ("node2vec", dict(a=4.0, b=0.25)),
    ("node2vec", dict(a=0.3, b=3.0, weighted=False)),
    ("deepwalk", dict()),
    ("deepwalk", dict(weighted=False)),
]
IDS = ["n2v", "n2v-a4-b0.25", "n2v-unweighted", "dw", "dw-unweighted"]
# the weight-rule checks skip the second Node2Vec parameter set: its
# constants only change the factors the bound test already covers
WEIGHT_CASES = [c for c, i in zip(PROGRAMS, IDS) if i != "n2v-a4-b0.25"]
WEIGHT_IDS = [i for i in IDS if i != "n2v-a4-b0.25"]


@pytest.fixture(scope="module")
def graphs():
    g = ref_power_law(300, 8, weight_dist="pareto", seed=2)
    return g, to_port_graph(g)


def _walkers(pg, n, seed):
    rng = np.random.default_rng(seed)
    V = pg.num_nodes
    indptr = pg.indptr.numpy().astype(np.int64)
    deg = np.diff(indptr)
    cur = rng.integers(0, V, n)
    off = (rng.random(n) * deg[cur]).astype(np.int64)
    prev = pg.indices.numpy()[indptr[cur] + off].astype(np.int64)
    prev[::7] = -1
    prev[3::11] = rng.integers(0, V, prev[3::11].size)
    step = rng.integers(0, 80, n)
    return cur, prev, step


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("name,kw", WEIGHT_CASES, ids=WEIGHT_IDS)
def test_tile_weights_bitwise(graphs, name, kw):
    g, pg = graphs
    wl, pw = ref_make_workload(name, **kw), make_workload(name, **kw)
    cur, prev, step = _walkers(pg, 512, 1)
    j = lambda a: jnp.asarray(a, jnp.int32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    for start, width in ((0, 32), (32, 64)):
        ctx, mask = ref_tile_ctx(g, wl, j(cur), j(prev), j(step),
                                 jnp.full((cur.size,), start, jnp.int32),
                                 width)
        want = ref_eval_weights(wl, wl.params(), ctx, mask)
        pctx, pmask = tile_ctx(pg, pw, t(cur), t(prev), t(step), start, width)
        got = eval_weights(pw, pw.params(), pctx, pmask)
        assert np.array_equal(np.asarray(mask), pmask.numpy())
        assert np.array_equal(_bits(want), _bits(got.numpy()))
        assert np.array_equal(np.asarray(ctx.dist), pctx.dist.numpy())
    assert (np.asarray(want) > 0).any()


@pytest.mark.parametrize("name,kw", WEIGHT_CASES, ids=WEIGHT_IDS)
def test_single_edge_weights_bitwise(graphs, name, kw):
    g, pg = graphs
    wl, pw = ref_make_workload(name, **kw), make_workload(name, **kw)
    cur, prev, step = _walkers(pg, 1024, 2)
    deg = np.diff(pg.indptr.numpy().astype(np.int64))[cur]
    off = (np.random.default_rng(3).random(cur.size) * deg).astype(np.int64)
    j = lambda a: jnp.asarray(a, jnp.int32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    ctx, valid = ref_single_edge_ctx(g, wl, j(cur), j(prev), j(step), j(off))
    want = jax.vmap(wl.edge_weight, in_axes=(0, None, 0))(
        ctx, wl.params(), None)
    pctx, pvalid = single_edge_ctx(pg, pw, t(cur), t(prev), t(step), t(off))
    got = pw.get_weight(pctx, pw.params())
    assert np.array_equal(np.asarray(valid), pvalid.numpy())
    assert np.array_equal(_bits(want), _bits(got.numpy()))


def _bound_inputs(n, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 3.0, n).astype(np.float32)
    hi = (lo + rng.pareto(1.0, n)).astype(np.float32)
    mean = (lo + rng.random(n) * (hi - lo)).astype(np.float32)
    deg = rng.integers(0, 5000, n).astype(np.int32)
    ints = [deg, rng.integers(0, 5000, n), rng.integers(0, 10**6, n),
            rng.integers(-1, 10**6, n), rng.integers(0, 80, n)]
    ref = RefBoundInputs(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(mean),
                         *(jnp.asarray(x, jnp.int32) for x in ints))
    port = BoundInputs(torch.from_numpy(lo), torch.from_numpy(hi),
                       torch.from_numpy(mean),
                       *(torch.from_numpy(np.asarray(x, np.int64))
                         for x in ints))
    return ref, port


@pytest.mark.parametrize("name,kw", PROGRAMS, ids=IDS)
def test_declared_bound_and_sum_match_compiler(name, kw):
    """The program's declared bound and Eq. 12 sum equal the reference
    compiler's synthesised ``bound_fn`` (hi endpoint) and ``sum_fn`` bit
    for bit; the flag and the static proof agree too."""
    wl, pw = ref_make_workload(name, **kw), make_workload(name, **kw)
    rc, pc = ref_analyze(wl), analyze(pw)
    assert (rc.flag, is_static(pw)) == (pc.flag, ref_is_static(wl))
    rb, pb = _bound_inputs(4096, 4)
    _, want_hi = jax.vmap(rc.bound_fn)(rb)
    want_sum = jax.vmap(rc.sum_fn)(rb)
    assert np.array_equal(_bits(want_hi), _bits(pc.bound_fn(pb).numpy()))
    assert np.array_equal(_bits(want_sum), _bits(pc.sum_fn(pb).numpy()))


def test_cost_model_decisions_match():
    rng = np.random.default_rng(5)
    n = 20000
    bmax = rng.pareto(1.0, n).astype(np.float32)
    bmax[::13] = 0.0
    ssum = (rng.pareto(0.5, n) * 4).astype(np.float32)
    deg = rng.integers(0, 10**6, n)
    deg[:100] = np.arange(100)
    ref, port = RefCostModel(), CostModel()
    want = ref.prefer_rjs(jnp.asarray(bmax), jnp.asarray(ssum),
                          jnp.asarray(deg, jnp.int32))
    got = port.prefer_rjs(torch.from_numpy(bmax), torch.from_numpy(ssum),
                          torch.from_numpy(deg))
    assert np.array_equal(np.asarray(want), got.numpy())
    for fs in (0.0, 0.25):
        want = ref.prefer_precomp(jnp.asarray(deg, jnp.int32), fs)
        got = port.prefer_precomp(torch.from_numpy(deg), fs)
        assert np.array_equal(np.asarray(want), got.numpy())


def test_kernel_rule_of_ported_programs():
    """The device rule carries the reference's float32 constants; a program
    without a hand-written rule gets the rule generated from its weight,
    and one whose weight cannot be lowered is refused, naming the op."""
    n2v = make_workload("node2vec", a=3.0, b=0.7)
    rule = kernel_rule(n2v, n2v.params())
    assert rule.c0 == np.float32(1 / 3.0) and rule.c2 == np.float32(1 / 0.7)
    import dataclasses

    from repro_torch.kernels.rules import GENERATED
    bare = dataclasses.replace(make_workload("deepwalk"), kernel_rule=None)
    assert kernel_rule(bare, ()).program == GENERATED
    unlowerable = dataclasses.replace(
        bare, get_weight=lambda c, p, ws: torch.cumsum(c.h, dim=-1))
    with pytest.raises(ValueError, match="cumsum"):
        kernel_rule(unlowerable, ())
