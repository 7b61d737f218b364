"""User programs through the port's compiler and generated device rules.

* Five user programs written twice (jnp for the reference, torch for the
  port) — the quickstart program, a sort (FALLBACK), Python branching on
  a tensor (FALLBACK), ``exp`` / ``log`` of h, and a non-backtracking walk
  whose weight reads ``wstate`` — give the reference's flag, warning
  kind, ``bound_fn``, ``sum_fn`` (bitwise), ``static_taint``,
  ``is_static`` and ``fuse_report``.
* ``rulegen``: its plain evaluator equals ``get_weight`` bitwise for every
  registry program it lowers, equals the reference's jnp weight for
  ``exp`` / ``log``; the weights that read ``wstate`` (visited_avoiding's
  ring, non_backtracking's last node) lower, and it raises naming the op
  for a sort, also over the ring, and naming the leaf for a leaf dtype it
  does not hold;
  its header rounds each float op alone, writes hex-float constants and a
  ``constexpr`` table; ``kernel_rule`` returns the hand rule where a
  program names one, else the generated rule.
* Stripped twins' ``run()`` equals the declared programs' (paths,
  fractions, fallbacks) under ``adaptive``, ``ervs`` and ``erjs``; the
  quickstart program's ``run()`` equals the reference's under the eRVS
  near-tie contract and passes chi-square against ``exact_probs``; the
  CLI runs a ``module:factory`` program registered at run time.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (chi2_vs_exact, one_torch_thread,  # noqa: F401
                         to_port_graph)
from test_torch_compiler import _ref_quickstart, assert_same_analysis, \
    bound_inputs
from test_torch_programs import _first_divergence_is_near_tie
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.core import WalkProgram as RefWalkProgram
from repro.core.types import EdgeCtx as RefEdgeCtx
from repro.graphs import power_law_graph as ref_power_law
from repro_torch import interop
from repro_torch.core import EngineConfig, WalkEngine, exact_probs
from repro_torch.core import flexi_compiler as fc
from repro_torch.core.ctxutil import eval_weights, tile_ctx
from repro_torch.core.types import EdgeCtx, WalkProgram
from repro_torch.kernels import rulegen
from repro_torch.kernels.ervs import kernel_rule
from repro_torch.kernels.rules import GENERATED, NODE2VEC
from repro_torch.launch import walk as walk_cli
from repro_torch.walks import make_workload
from repro_torch.walks.examples import (degree_damped, non_backtracking,
                                        stripped)

N = 1024


# ---------------------------------------------- the user programs, twice
def _sort_programs():
    ref = RefWalkProgram(
        name="sorted", init=lambda: (),
        get_weight=lambda c, p, ws: jnp.sort(jnp.stack([c.h, c.h * 2]))[0])
    port = WalkProgram(
        name="sorted", init=lambda: (),
        get_weight=lambda c, p, ws: torch.sort(
            torch.stack([c.h, c.h * 2], dim=-1), dim=-1).values[..., 0])
    return ref, port


def _branch_programs():
    def ref_gw(c, p, ws):
        if c.h > 1:  # Python branching on a traced value
            return c.h
        return c.h * 2

    def port_gw(c, p, ws):
        if bool((c.h > 1).all()):
            return c.h
        return c.h * 2

    return (RefWalkProgram(name="branchy", init=lambda: (),
                           get_weight=ref_gw),
            WalkProgram(name="branchy", init=lambda: (), get_weight=port_gw))


def _exp_programs():
    """w = log(h + 1) * exp(-0.5 h): static, through XLA's exp and log."""
    ref = RefWalkProgram(
        name="exp-log", init=lambda: (),
        get_weight=lambda c, p, ws: jnp.log(c.h + 1.0) * jnp.exp(-0.5 * c.h))
    port = WalkProgram(
        name="exp-log", init=lambda: (),
        get_weight=lambda c, p, ws: torch.log(c.h + 1.0) * torch.exp(
            -0.5 * c.h))
    return ref, port


def _nonbacktracking_programs():
    """w = 0 for the node the walker last left (its wstate), else h (the
    port half: ``walks.examples.non_backtracking``)."""
    ref = RefWalkProgram(
        name="non-backtracking", init=lambda: (),
        get_weight=lambda c, p, last: jnp.where(c.nbr == last, 0.0, c.h),
        init_walker_state=lambda q: jnp.int32(-1),
        on_step=lambda c, p, last: c.cur.astype(jnp.int32))
    return ref, non_backtracking()


def _last_nodes(n, seed):
    rng = np.random.default_rng(seed)
    last = rng.integers(-1, 50, n).astype(np.int32)
    last[::3] = 0  # the Eq. 12 enumeration's nbr
    return jnp.asarray(last), interop.wstate_from_arrays(last)


USER = {
    "quickstart": lambda: (_ref_quickstart(), degree_damped()),
    "sort": _sort_programs,
    "branch": _branch_programs,
    "exp_log": _exp_programs,
    "non_backtracking": _nonbacktracking_programs,
}
USER_FLAGS = {"quickstart": "PER_STEP", "sort": "FALLBACK",
              "branch": "FALLBACK", "exp_log": "PER_STEP",
              "non_backtracking": "PER_STEP"}


@pytest.mark.parametrize("name", sorted(USER))
def test_user_program_analysis_matches_reference(name):
    ref, port = USER[name]()
    ws = (None, None)
    if name == "quickstart":
        mass = np.random.default_rng(40).random(N).astype(np.float32)
        ws = (jnp.asarray(mass), interop.wstate_from_arrays(mass))
    elif name == "non_backtracking":
        ws = _last_nodes(N, 41)
    rb, pb = bound_inputs(N, 42, *ws)
    assert fc.analyze(port).flag == USER_FLAGS[name]
    assert_same_analysis(ref, port, rb, pb)


def test_user_program_facts():
    assert fc.is_static(_exp_programs()[1])
    assert not fc.is_static(_nonbacktracking_programs()[1])
    assert fc.static_taint(_nonbacktracking_programs()[1]) == frozenset(
        {"nbr", "wstate", "h"})
    for make in (_sort_programs, _branch_programs):
        port = make()[1]
        assert fc.static_taint(port) is None
        assert not fc.fuse_report(port).fusable


# --------------------------------------------------------------- rulegen
LOWERED = [("node2vec", {}), ("node2vec", dict(weighted=False)),
           ("metapath", {}), ("metapath", dict(schema=(2, 0, 2))),
           ("metapath_unweighted", {}), ("2ndpr", {}),
           ("2ndpr", dict(gamma=0.35, weighted=False)), ("deepwalk", {}),
           ("deepwalk", dict(weighted=False)), ("ppr_nibble", {})]


@pytest.fixture(scope="module")
def small_graph():
    g = ref_power_law(300, 8, seed=3)
    return g, to_port_graph(g)


def _walkers(pg, n, seed):
    rng = np.random.default_rng(seed)
    V = pg.num_nodes
    indptr = pg.indptr.numpy().astype(np.int64)
    cur = rng.integers(0, V, n)
    off = (rng.random(n) * np.diff(indptr)[cur]).astype(np.int64)
    prev = pg.indices.numpy()[indptr[cur] + off].astype(np.int64)
    prev[::7] = -1
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64))
    return t(cur), t(prev), t(rng.integers(0, 80, n))


@pytest.mark.parametrize("name,kw", LOWERED,
                         ids=[n + "".join(f"-{k}={v}" for k, v in kw.items())
                              for n, kw in LOWERED])
def test_rulegen_evaluator_equals_get_weight(small_graph, name, kw):
    _, pg = small_graph
    prog = make_workload(name, **kw)
    low = rulegen.lower(prog)
    cur, prev, step = _walkers(pg, 400, 43)
    for t0 in (0, 16):
        ctx, mask = tile_ctx(pg, prog, cur, prev, step, t0, 32)
        want = eval_weights(prog, prog.params(), ctx, mask)
        got = torch.where(mask, torch.clamp_min(rulegen.evaluate(low, ctx),
                                                0.0), 0.0)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_rulegen_exp_log_equals_the_reference():
    """exp and log lower to XLA-CPU's polynomials: the evaluator gives the
    reference's jnp weight bit for bit."""
    ref, port = _exp_programs()
    h = np.random.default_rng(44).uniform(0.0, 30.0, 4096).astype(
        np.float32)
    z = np.zeros(h.shape, np.int32)
    rctx = RefEdgeCtx(*(jnp.asarray(x) for x in (h, z, z, z, z, z, z, z, z)))
    want = np.asarray(ref.get_weight(rctx, (), None))
    zt = torch.zeros(h.shape, dtype=torch.int64)
    pctx = EdgeCtx(torch.from_numpy(h), *([zt] * 8))
    got = rulegen.evaluate(rulegen.lower(port), pctx).numpy()
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


def test_rulegen_raises_naming_the_op_or_field():
    with pytest.raises(ValueError, match="sort"):
        rulegen.lower(_sort_programs()[1])
    # weights that read wstate lower: the ring and the last node are state
    # reads the generated rule makes
    for prog in (_nonbacktracking_programs()[1],
                 make_workload("visited_avoiding")):
        assert rulegen.lower(prog).reads_leaves == {0}
    with pytest.raises(ValueError, match="traced"):
        rulegen.lower(_branch_programs()[1])
    # what still raises on a state read: a sort over the ring, a leaf of a
    # dtype the generated rule does not hold
    visited = make_workload("visited_avoiding")

    def sorted_ring(c, p, ws):
        first = ws[0].sort(dim=-1).values[:, 0]
        return torch.where(first == c.nbr, 0.0, c.h)
    with pytest.raises(ValueError, match="sort.*wstate leaf 0"):
        rulegen.lower(dataclasses.replace(visited, get_weight=sorted_ring))
    nb = non_backtracking()
    wide = dataclasses.replace(nb, init_walker_state=lambda q: (torch.full(
        (q.shape[0],), -1, dtype=torch.float64),))
    with pytest.raises(ValueError, match="wstate leaf 0 of dtype "
                                         "torch.float64"):
        kernel_rule(stripped(wide), ())


def test_rulegen_header():
    src = rulegen.cuda_source(rulegen.lower(make_workload("metapath")))
    assert "constexpr long long kTable0[5] = {0LL, 1LL, 2LL, 3LL, 4LL};" \
        in src and "kGenReadsLabel = true" in src
    src = rulegen.cuda_source(rulegen.lower(make_workload("node2vec")))
    assert "0x1.0000000000000p-1f" in src and "__fmul_rn" in src
    assert "kGenReadsDist = true" in src and "dist()" in src
    src = rulegen.cuda_source(rulegen.lower(degree_damped()))
    assert "__fsqrt_rn" in src and "__fdiv_rn" in src
    assert "kGenReadsDegPrev = true" in src and "dist()" not in src
    src = rulegen.cuda_source(rulegen.lower(_exp_programs()[1]))
    assert "xla_exp" in src and "xla_log" in src


def test_kernel_rule_hand_or_generated():
    n2v = make_workload("node2vec")
    assert kernel_rule(n2v, n2v.params()).program == NODE2VEC
    bare = stripped(n2v)
    params = bare.params()
    rule = kernel_rule(bare, params)
    assert rule.program == GENERATED and rule.header
    assert kernel_rule(bare, params) is rule  # built once
    other = stripped(make_workload("node2vec", a=4.0))
    assert kernel_rule(other, other.params()).header != rule.header


# ------------------------------------------------------------- the engine
TWIN_CASES = [(n, m) for n in ("node2vec", "metapath", "deepwalk")
              for m in ("adaptive", "ervs", "erjs")]


@pytest.mark.parametrize("name,method", TWIN_CASES,
                         ids=[f"{n}-{m}" for n, m in TWIN_CASES])
def test_stripped_twin_runs_like_the_declared_program(small_graph, name,
                                                      method):
    _, pg = small_graph
    kw = dict(method=method, device="cpu", tile=16, jump_threshold=4)
    res = [WalkEngine(pg, p, EngineConfig(**kw)).run(
        np.arange(300), num_steps=8, batch=128, epoch_len=3)
        for p in (make_workload(name), stripped(make_workload(name)))]
    assert np.array_equal(res[0].paths, res[1].paths)
    for f in ("frac_rjs", "frac_precomp", "rjs_fallbacks", "live_steps"):
        assert getattr(res[0], f) == getattr(res[1], f), f


def test_quickstart_run_matches_reference(small_graph):
    g, pg = small_graph
    kw = dict(method="adaptive", tile=16, jump_threshold=4)
    starts = np.arange(300)
    ref = RefEngine(g, _ref_quickstart(), RefConfig(**kw)).run(
        starts, num_steps=10, batch=128, epoch_len=3)
    eng = WalkEngine(pg, degree_damped(), EngineConfig(device="cpu", **kw))
    assert eng.compiled.flag == "PER_STEP" and eng.precomp is None
    got = eng.run(starts, num_steps=10, batch=128, epoch_len=3)
    same = (ref.paths == got.paths).all(axis=1)
    print(f"quickstart: {same.mean():.4f} of paths equal, frac_rjs "
          f"{got.frac_rjs:.4f}")
    for q in np.nonzero(~same)[0]:
        assert _first_divergence_is_near_tie(eng, ref.paths, got.paths, q)
    if same.all():
        for f in ("frac_rjs", "rjs_fallbacks", "live_steps"):
            assert getattr(got, f) == getattr(ref, f), f
    assert got.frac_rjs > 0
    emitted = (got.paths[:, 1:] >= 0).sum(axis=1)
    assert emitted.max() == 9  # the mass falls below 0.25 after 9 steps


def test_quickstart_chi_square(small_graph):
    _, pg = small_graph
    eng = WalkEngine(pg, degree_damped(), EngineConfig(device="cpu"))
    v = int(np.argsort(pg.degrees().numpy())[-2])
    res = eng.run(np.full(2000, v), num_steps=2)
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


def test_cli_runs_a_program_registered_at_run_time(capsys):
    from repro_torch.walks import WORKLOADS

    name = "repro_torch.walks.examples:degree_damped"
    try:
        walk_cli.main(["--nodes", "300", "--queries", "40", "--steps", "5",
                       "--device", "cpu", "--workload", name])
    finally:
        WORKLOADS.pop(name, None)
    out = capsys.readouterr().out
    assert "compiler flag: PER_STEP" in out and "static=False" in out

