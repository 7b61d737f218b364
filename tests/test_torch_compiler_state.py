"""Weights that read the walker's state, through the compiler and the
generated device rules, on the CPU.

* ``rulegen``'s plain evaluator equals ``get_weight`` bitwise for
  visited_avoiding (windows 16 and 5) and non_backtracking on seeded
  walkers and states (rings holding some of the walker's neighbours,
  empty slots and other nodes); the header holds a vector leaf as a
  pointer to the walker's row and reads its slots;
* non_backtracking's staged run equals the reference's under the eRVS
  near-tie contract, and its draws fit ``exact_probs`` (chi-square);
* what ``rulegen`` still refuses on a state read raises, naming it: a sort
  over the ring, a leaf of another dtype, a float sum over a leaf, a leaf
  wider than ``MAX_GEN_WIDTH``, a reduction over the walker dim.

The generated code itself runs only on the card
(``test_torch_compiler_card.py``, ``chip_smoke.py`` phase 4c).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import (chi2_vs_exact, one_torch_thread,  # noqa: F401
                         to_port_graph)
from test_torch_compiler_user import _nonbacktracking_programs
from test_torch_programs import _first_divergence_is_near_tie
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.graphs import power_law_graph as ref_power_law
from repro_torch.core import EngineConfig, WalkEngine, exact_probs
from repro_torch.core.ctxutil import eval_weights, tile_ctx
from repro_torch.kernels import rulegen
from repro_torch.kernels.rules import MAX_GEN_WIDTH
from repro_torch.walks import make_workload
from repro_torch.walks.examples import non_backtracking, stripped

V = 300


@pytest.fixture(scope="module")
def small_graph():
    g = ref_power_law(V, 8, seed=3)
    return g, to_port_graph(g)


def _walkers(pg, n, seed):
    """Walkers on rows of the graph, their previous nodes (a neighbour, or
    -1) and steps."""
    rng = np.random.default_rng(seed)
    indptr = pg.indptr.numpy().astype(np.int64)
    cur = rng.choice(np.nonzero(np.diff(indptr) > 0)[0], n)
    off = (rng.random(n) * np.diff(indptr)[cur]).astype(np.int64)
    prev = pg.indices.numpy()[indptr[cur] + off].astype(np.int64)
    prev[::7] = -1
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64))
    return t(cur), t(prev), t(rng.integers(0, 80, n))


def _state(pg, prog, cur, prev, seed):
    """Seeded state of the walkers: rings of some of the walker's
    neighbours, -1 and other nodes; or the node last left (its previous
    node, or another)."""
    rng = np.random.default_rng(seed)
    n = cur.shape[0]
    if prog.name == "non-backtracking":
        last = np.where(rng.random(n) < 0.7, prev.numpy(),
                        rng.integers(-1, V, n))
        return (torch.from_numpy(last.astype(np.int32)),)
    window = prog.params().window
    indptr = pg.indptr.numpy().astype(np.int64)
    deg = np.diff(indptr)[cur.numpy()]
    slot = (rng.random((n, window)) * deg[:, None]).astype(np.int64)
    ring = pg.indices.numpy()[indptr[cur.numpy()][:, None] + slot]
    pick = rng.random(ring.shape)
    ring = np.where(pick < 0.25, -1, np.where(
        pick < 0.4, rng.integers(0, V, ring.shape), ring))
    return (torch.from_numpy(ring.astype(np.int32)),)


STATEFUL = {"visited-16": lambda: make_workload("visited_avoiding"),
            "visited-5": lambda: make_workload("visited_avoiding", window=5),
            "non_backtracking": non_backtracking}


@pytest.mark.parametrize("name", sorted(STATEFUL))
def test_state_weight_evaluator_equals_get_weight(small_graph, name):
    _, pg = small_graph
    prog = STATEFUL[name]()
    low = rulegen.lower(prog)
    assert low.reads_leaves == {0} and "nbr" in low.reads
    cur, prev, step = _walkers(pg, 400, 43)
    ws = _state(pg, prog, cur, prev, 44)
    for t0 in (0, 16):
        ctx, mask = tile_ctx(pg, prog, cur, prev, step, t0, 32)
        want = eval_weights(prog, prog.params(), ctx, mask, ws)
        got = torch.where(mask, torch.clamp_min(
            rulegen.evaluate(low, ctx, ws), 0.0), 0.0)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        if name != "non_backtracking":  # some edges hit the ring
            assert ((want == 0) & mask).any()


def test_state_header_reads_the_walkers_row():
    src = rulegen.cuda_source(rulegen.lower(stripped(make_workload(
        "visited_avoiding"))))
    assert "int* l0;  // [16] a walker" in src
    assert "s.l0 = static_cast<int*>(L.p[0]) + w * 16;" in src
    assert "w.gen.l0[15]" in src and "kGenReadsNbr = true" in src
    src = rulegen.cuda_source(rulegen.lower(non_backtracking()))
    assert "  int l0;" in src and "const int v" in src and "w.gen.l0;" in src
    assert "static_cast<const int*>(L.p[0])[w]" in src


def test_nonbacktracking_run_matches_reference(small_graph):
    g, pg = small_graph
    kw = dict(method="adaptive", tile=16, jump_threshold=4)
    starts = np.arange(V)
    ref = RefEngine(g, _nonbacktracking_programs()[0], RefConfig(**kw)).run(
        starts, num_steps=10, batch=128, epoch_len=3)
    eng = WalkEngine(pg, non_backtracking(), EngineConfig(device="cpu", **kw))
    got = eng.run(starts, num_steps=10, batch=128, epoch_len=3)
    same = (ref.paths == got.paths).all(axis=1)
    for q in np.nonzero(~same)[0]:
        assert _first_divergence_is_near_tie(eng, ref.paths, got.paths, q)
    if same.all():
        for f in ("frac_rjs", "rjs_fallbacks", "live_steps"):
            assert getattr(got, f) == getattr(ref, f), f
    # no walker steps straight back where it has another neighbour
    p = got.paths
    back = (p[:, 2:] >= 0) & (p[:, 2:] == p[:, :-2])
    deg = np.diff(pg.indptr.numpy())
    assert (deg[p[:, 1:-1][back]] == 1).all()


def test_nonbacktracking_chi_square(small_graph):
    _, pg = small_graph
    eng = WalkEngine(pg, non_backtracking(), EngineConfig(device="cpu"))
    v = int(np.argsort(pg.degrees().numpy())[-2])
    res = eng.run(np.full(2000, v), num_steps=2)
    u = int(np.bincount(res.paths[:, 1]).argmax())
    sel = res.paths[:, 1] == u
    assert v not in res.paths[sel, 2]
    p, nbr = exact_probs(eng.graph, eng.workload, eng.sampler_ctx.params, u,
                         v, 1, eng.pad,
                         wstate=(torch.tensor(v, dtype=torch.int32),))
    assert p[nbr == v].sum() == 0
    chi2, crit = chi2_vs_exact(res.paths[sel, 2], p, nbr)
    assert chi2 < crit, f"second step: chi2={chi2:.1f} >= {crit:.1f}"


def _refused():
    """(program, what the error must name) a state read rulegen refuses."""
    visited = make_workload("visited_avoiding")
    nb = non_backtracking()

    def sorted_ring(c, p, ws):
        first = ws[0].sort(dim=-1).values[:, 0]
        return torch.where(first == c.nbr, 0.0, c.h)

    def float_sum(c, p, ws):
        return c.h * ws[0].to(torch.float32).sum(-1)

    def over_walkers(c, p, ws):
        return torch.where((ws[0] == c.nbr.unsqueeze(-1)).any(), 0.0, c.h)

    def leaves(dtype, width=None):
        shape = () if width is None else (width,)
        return lambda q: (torch.full((q.shape[0],) + shape, -1,
                                     dtype=dtype),)
    return {
        "sort": (dataclasses.replace(visited, get_weight=sorted_ring),
                 "sort.*wstate leaf 0"),
        "float64": (dataclasses.replace(nb, init_walker_state=leaves(
            torch.float64)), "wstate leaf 0 of dtype torch.float64"),
        "int8": (dataclasses.replace(nb, init_walker_state=leaves(
            torch.int8)), "wstate leaf 0 of dtype torch.int8"),
        "float_sum": (dataclasses.replace(visited, get_weight=float_sum),
                      "float sum"),
        "too_wide": (make_workload("visited_avoiding",
                                   window=MAX_GEN_WIDTH + 1),
                     f"width {MAX_GEN_WIDTH + 1}"),
        "over_walkers": (dataclasses.replace(visited,
                                             get_weight=over_walkers),
                         "any over every dim"),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_rulegen_refuses_state_reads_naming_them(case):
    prog, match = _refused()[case]
    with pytest.raises(ValueError, match=match):
        rulegen.generated_rule(stripped(prog), prog.params())
