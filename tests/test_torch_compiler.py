"""The port's Flexi-Compiler on the registry programs, against the
reference compiler on the same inputs.

* For all eight registry programs (and the second parameter sets of the
  declared-bound tests), declared and stripped of their declarations and
  device rules: the flag, the warnings, the synthesised ``bound_fn`` (hi
  end) and Eq. 12 ``sum_fn`` bitwise with the reference's (vmapped over
  walkers) on seeded ``BoundInputs``, ``static_taint``, ``is_static`` and
  ``fuse_report``.
* The declared bound and sum equal the analysed ones bitwise.
* ``tests/test_flexi_compiler.py``'s cases with deterministic seeds: the
  flag lattice, FALLBACK for an unsupported op and for Python branching,
  the bound's soundness on edges drawn in the declared domains, the sum's
  scaling with the degree, Node2Vec's max(w)·max(h) factorisation and
  2nd-order PageRank's Eq. 3 bound.
* The quickstart program's facts come from its weight, not from
  declarations: PER_STEP, not static, its bound not node-local, as the
  reference finds (the port called it FALLBACK and static before).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from repro.core import BoundInputs as RefBoundInputs
from repro.core import WalkProgram as RefWalkProgram
from repro.core import flexi_compiler as ref_fc
from repro.core.types import EdgeCtx as RefEdgeCtx
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import (FALLBACK, PER_KERNEL, PER_STEP, BoundInputs,
                              analyze)
from repro_torch.core import flexi_compiler as fc
from repro_torch.core.types import EdgeCtx, WalkProgram, Workload
from repro_torch.walks import make_workload
from repro_torch.walks.examples import degree_damped, stripped

REGISTRY = ["node2vec", "node2vec_unweighted", "metapath",
            "metapath_unweighted", "2ndpr", "deepwalk", "visited_avoiding",
            "ppr_nibble"]
CASES = [(n, {}) for n in REGISTRY] + [
    ("metapath", dict(schema=(2, 0, 2))), ("2ndpr", dict(gamma=0.35)),
    ("2ndpr", dict(weighted=False)), ("ppr_nibble", dict(weighted=False)),
    ("visited_avoiding", dict(a=0.3, b=3.0, window=5, weighted=False)),
]
IDS = [n + "".join(f"-{k}={v}" for k, v in kw.items()) for n, kw in CASES]
N = 1024


def _bits(a):
    return np.asarray(a).view(np.uint32)


def bound_inputs(n: int, seed: int, ws_ref=None, ws_port=None):
    """(reference, port) BoundInputs of n walkers from one numpy seed."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 3.0, n).astype(np.float32)
    hi = (lo + rng.pareto(1.0, n)).astype(np.float32)
    mean = (lo + rng.random(n) * (hi - lo)).astype(np.float32)
    ints = [rng.integers(0, 5000, n), rng.integers(0, 5000, n),
            rng.integers(0, 10**6, n), rng.integers(-1, 10**6, n),
            rng.integers(0, 80, n)]
    rb = RefBoundInputs(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(mean),
                        *(jnp.asarray(x, jnp.int32) for x in ints),
                        wstate=ws_ref)
    pb = BoundInputs(torch.from_numpy(lo), torch.from_numpy(hi),
                     torch.from_numpy(mean),
                     *(torch.from_numpy(np.asarray(x, np.int64))
                       for x in ints), wstate=ws_port)
    return rb, pb


def registry_wstate(name, kw, n, seed):
    """(reference, port) per-walker state: rings holding empty slots, node
    0 (the Eq. 12 enumeration's nbr) and other nodes; masses."""
    rng = np.random.default_rng(seed)
    if name == "visited_avoiding":
        ring = rng.integers(-1, 50, (n, kw.get("window", 16))).astype(
            np.int32)
        ring[::5] = -1
        ring[1::7, 0] = 0
        return jnp.asarray(ring), interop.wstate_from_arrays(ring)
    if name == "ppr_nibble":
        mass = rng.random(n).astype(np.float32)
        return jnp.asarray(mass), interop.wstate_from_arrays(mass)
    return None, None


def warning_kind(warnings) -> str:
    """The reference's warning classes: untraceable, unsupported, none."""
    text = " ".join(warnings)
    for kind in ("not traceable", "unsupported primitive"):
        if kind in text:
            return kind
    return "none" if not warnings else text


def assert_same_analysis(ref_prog, port_prog, rb, pb):
    """Flag, warning kind, bound and sum bitwise, static taint, static
    proof and fusability of the two programs' compilers."""
    rc, pc = ref_fc.analyze(ref_prog), fc.analyze(port_prog)
    assert pc.flag == rc.flag
    assert warning_kind(pc.warnings) == warning_kind(rc.warnings)
    if rc.usable:
        _, want_hi = jax.vmap(rc.bound_fn)(rb)
        want_sum = jax.vmap(rc.sum_fn)(rb)
        assert np.array_equal(_bits(want_hi), _bits(pc.bound_fn(pb)))
        assert np.array_equal(_bits(want_sum), _bits(pc.sum_fn(pb)))
    assert fc.static_taint(port_prog) == ref_fc.static_taint(ref_prog)
    assert fc.is_static(port_prog) == ref_fc.is_static(ref_prog)
    want, got = ref_fc.fuse_report(ref_prog), fc.fuse_report(port_prog)
    assert (got.weight_fusable, got.hooks_fusable, got.bound_node_local,
            got.fusable) == (want.weight_fusable, want.hooks_fusable,
                             want.bound_node_local, want.fusable)
    assert bool(got.reasons) == bool(want.reasons)


@pytest.mark.parametrize("declared", [True, False],
                         ids=["declared", "stripped"])
@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_registry_analysis_matches_reference(name, kw, declared):
    ws_ref, ws_port = registry_wstate(name, kw, N, seed=5)
    rb, pb = bound_inputs(N, 4, ws_ref, ws_port)
    prog = make_workload(name, **kw)
    assert_same_analysis(ref_make_workload(name, **kw),
                         prog if declared else stripped(prog), rb, pb)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_declared_bound_and_sum_equal_the_analysis(name, kw):
    """The declarations (the tests' oracle) equal what the compiler
    derives, bit for bit; so do the declared read fields and the taint."""
    ws_ref, ws_port = registry_wstate(name, kw, N, seed=6)
    _, pb = bound_inputs(N, 7, ws_ref, ws_port)
    prog = make_workload(name, **kw)
    pc = fc.analyze(stripped(prog))
    params = prog.params()
    assert np.array_equal(_bits(prog.bound(pb, params)),
                          _bits(pc.bound_fn(pb)))
    assert np.array_equal(_bits(prog.weight_sum(pb, params)),
                          _bits(pc.sum_fn(pb)))
    runtime = fc.static_taint(stripped(prog)) - (
        set() if prog.weighted else {"h"})
    assert runtime == prog.reads


# ------------------------------------- tests/test_flexi_compiler.py, ported
def make_bi(h_min, h_max, h_mean, deg_cur, deg_prev, step=0):
    f = lambda x: torch.tensor([x], dtype=torch.float32)
    i = lambda x: torch.tensor([x], dtype=torch.int64)
    return BoundInputs(f(h_min), f(h_max), f(h_mean), i(deg_cur),
                       i(deg_prev), i(0), i(1), i(step))


def test_flag_lattice():
    assert analyze(stripped(make_workload("node2vec_unweighted"))).flag \
        == PER_KERNEL
    assert analyze(stripped(make_workload("node2vec"))).flag == PER_STEP
    assert analyze(stripped(make_workload("2ndpr"))).flag == PER_STEP


def test_fallback_on_unsupported():
    with pytest.warns(DeprecationWarning):
        bad = Workload(name="bad", init=lambda: (),
                       get_weight=lambda c, p: torch.sort(
                           torch.stack([c.h, c.h * 2], dim=-1),
                           dim=-1).values[..., 0])
    cw = analyze(bad)
    assert cw.flag == FALLBACK and not cw.usable
    assert any("unsupported" in w and "sort" in w for w in cw.warnings)


def test_fallback_on_untraceable():
    def gw(c, p):
        if c.h.sum() > 1:  # Python branching on a tensor
            return c.h
        return c.h * 2

    with pytest.warns(DeprecationWarning):
        wl = Workload(name="untraceable", init=lambda: (), get_weight=gw)
    cw = analyze(wl)
    assert cw.flag == FALLBACK and "not traceable" in cw.warnings[0]
    assert fc.static_taint(wl) is None and not fc.is_static(wl)
    assert not fc.fuse_report(wl).fusable


@pytest.mark.parametrize("rule,op", [
    (lambda c, p, ws: c.h[c.h > 0], "boolean mask"),
    (lambda c, p, ws: c.h * torch.nonzero(c.h).sum(), "nonzero"),
    (lambda c, p, ws: torch.masked_select(c.h, c.dist > 0), "masked_select"),
], ids=["mask", "nonzero", "masked_select"])
def test_fallback_on_data_dependent_shapes(rule, op):
    prog = WalkProgram(name="shapes", init=lambda: (), get_weight=rule)
    cw = analyze(prog)
    assert cw.flag == FALLBACK and op in cw.warnings[0]
    assert fc.static_taint(prog) is None


SOUND_PROGRAMS = [("node2vec", {}), ("node2vec", dict(weighted=False)),
                  ("metapath", {}), ("2ndpr", {}), ("deepwalk", {})]


@pytest.mark.parametrize("name,kw", SOUND_PROGRAMS,
                         ids=[n + ("-u" if kw else "") for n, kw in
                              SOUND_PROGRAMS])
def test_bound_dominates(name, kw):
    """For edges drawn in the declared domains, get_weight(ctx) <= the
    analysed bound (the Eqs. 5-8 requirement), 60 seeded draws."""
    prog = stripped(make_workload(name, **kw))
    cw = analyze(prog)
    assert cw.usable
    rng = np.random.default_rng(23)
    for _ in range(60):
        h = float(rng.uniform(0.1, 100.0))
        h_min = h * float(rng.uniform(0.0, 1.0))
        dist, label = int(rng.integers(0, 3)), int(rng.integers(0, 5))
        deg_cur, deg_prev = (int(x) for x in rng.integers(1, 10_001, 2))
        step = int(rng.integers(0, 101))
        hi = float(cw.bound_fn(make_bi(h_min, h, (h_min + h) / 2, deg_cur,
                                       deg_prev, step))[0])
        i = lambda x: torch.tensor([x], dtype=torch.int64)
        ctx = EdgeCtx(h=torch.tensor([h if prog.weighted else 1.0],
                                     dtype=torch.float32),
                      label=i(label), dist=i(dist), nbr=i(0),
                      deg_cur=i(deg_cur), deg_prev=i(deg_prev), cur=i(0),
                      prev=i(1), step=i(step))
        w = float(prog.get_weight(ctx, prog.params(), None)[0])
        assert w <= hi * (1 + 1e-5) + 1e-6, f"{name}: w={w} > bound={hi}"


def test_sum_estimate_scales_with_degree():
    cw = analyze(stripped(make_workload("node2vec")))
    rng = np.random.default_rng(29)
    for _ in range(30):
        h, deg = float(rng.uniform(0.5, 10.0)), int(rng.integers(1, 1001))
        s1 = float(cw.sum_fn(make_bi(h, h, h, deg, 4))[0])
        s2 = float(cw.sum_fn(make_bi(h, h, h, deg * 2, 4))[0])
        assert s2 == pytest.approx(2 * s1, rel=1e-5)


def test_node2vec_bound_matches_paper_factorization():
    """max(w)·max(h) of §3.3: a=2, b=0.5 gives max(w)=2; h_max=5 gives 10."""
    cw = analyze(stripped(make_workload("node2vec", a=2.0, b=0.5)))
    assert float(cw.bound_fn(make_bi(1.0, 5.0, 2.0, 10, 10))[0]) == \
        pytest.approx(10.0)


def test_2ndpr_bound_matches_eq3():
    cw = analyze(stripped(make_workload("2ndpr", gamma=0.2)))
    # ((1-γ)/dv + γ/dp)·max_d·h_max = (0.08+0.05)·10·5
    assert float(cw.bound_fn(make_bi(1.0, 5.0, 2.0, 10, 4))[0]) == \
        pytest.approx(6.5, rel=1e-5)


def test_bound_fn_on_a_batch_and_an_empty_one():
    cw = analyze(stripped(make_workload("node2vec")))
    bi = BoundInputs(
        h_min=torch.ones(8), h_max=torch.full((8,), 3.0),
        h_mean=torch.full((8,), 2.0),
        deg_cur=torch.arange(1, 9), deg_prev=torch.ones(8, dtype=torch.long),
        cur=torch.zeros(8, dtype=torch.long),
        prev=torch.zeros(8, dtype=torch.long),
        step=torch.zeros(8, dtype=torch.long))
    hi = cw.bound_fn(bi)
    assert hi.shape == (8,) and hi.dtype == torch.float32
    empty = BoundInputs(*(getattr(bi, f.name)[:0] for f in
                          dataclasses.fields(bi) if f.name != "wstate"))
    assert cw.bound_fn(empty).shape == (0,)
    assert cw.sum_fn(empty).shape == (0,)


# ----------------------------------------------------- the repair's test
def _ref_quickstart():
    def get_weight(ctx, params, mass):
        return ctx.h / jnp.sqrt(ctx.deg_prev.astype(jnp.float32) + 1.0)

    return RefWalkProgram(
        name="degree-damped", init=lambda: (), get_weight=get_weight,
        init_walker_state=lambda q: jnp.float32(1.0),
        on_step=lambda ctx, p, mass: mass * 0.85,
        should_stop=lambda ctx, p, mass: mass < 0.25, weighted=True)


def test_quickstart_facts_come_from_its_weight():
    """``w = h / sqrt(deg_prev + 1)`` reads deg_prev: PER_STEP, not
    static, its bound not node-local — the reference's findings, from the
    traced weight (no declaration)."""
    ref, port = _ref_quickstart(), degree_damped()
    rc, pc = ref_fc.analyze(ref), fc.analyze(port)
    assert (pc.flag, rc.flag) == (PER_STEP, PER_STEP)
    assert not fc.is_static(port) and not ref_fc.is_static(ref)
    got, want = fc.fuse_report(port), ref_fc.fuse_report(ref)
    assert not got.bound_node_local and not want.bound_node_local
    assert fc.static_taint(port) == ref_fc.static_taint(ref)
    rng = np.random.default_rng(31)
    mass = rng.random(N).astype(np.float32)
    rb, pb = bound_inputs(N, 32, jnp.asarray(mass),
                          interop.wstate_from_arrays(mass))
    assert_same_analysis(ref, port, rb, pb)


def test_workload_and_adapter_trace_the_same_graph():
    """A legacy ``Workload`` and ``from_workload`` of it analyse as the
    program they wrap (the adapter drops wstate: the same traced graph)."""
    from repro_torch.core.types import from_workload

    native = make_workload("2ndpr")
    with pytest.warns(DeprecationWarning):
        legacy = Workload(
            name=native.name, init=native.init,
            get_weight=lambda ctx, p: native.get_weight(ctx, p, None),
            needs_dist=True)
    gms = [fc.trace_weight(p)[0] for p in (native, legacy,
                                           from_workload(legacy))]
    codes = [gm.code for gm in gms]
    assert codes[0] == codes[1] == codes[2]
    rb, pb = bound_inputs(N, 33)
    for p in (legacy, from_workload(legacy)):
        assert_same_analysis(ref_make_workload("2ndpr"), p, rb, pb)


def test_ref_edge_ctx_fields_match():
    """The port traces the nine EdgeCtx fields in the reference's order."""
    assert fc.CTX_FIELDS == tuple(
        f.name for f in dataclasses.fields(RefEdgeCtx))
