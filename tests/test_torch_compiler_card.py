"""Generated device rules on the card (``cuda`` marker: skipped without
one; run on the chip with ``JAX_PLATFORMS=cpu PYTHONPATH=src python -m
pytest -q -m cuda tests/test_torch_compiler_card.py``).

* K1 (plain and jump), K2 and K4 under the generated rules of stripped
  node2vec, metapath and deepwalk choose bit for bit as under the hand
  rules, and K1 / K2 under the quickstart program's rule agree with
  their plain versions.
* The quickstart program runs adaptive on the card and launches K1 and
  K2; a program whose weight rulegen cannot lower (a sort) or that reads
  ``wstate`` raises there, naming the op or field.
"""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, one_torch_thread  # noqa: F401
from repro_torch.core import EngineConfig, WalkEngine
from repro_torch.core import erjs as erjs_mod
from repro_torch.core.types import WalkerState, WalkProgram
from repro_torch.graphs import power_law_graph
from repro_torch.kernels import build, megastep
from repro_torch.kernels.erjs import erjs_select
from repro_torch.kernels.ervs import ervs_select
from repro_torch.kernels.prng import key_data
from repro_torch.walks import make_workload
from repro_torch.walks.examples import degree_damped, stripped


def _walkers(graph, n, seed):
    rng = np.random.default_rng(seed)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    deg = np.diff(indptr)
    cur = rng.choice(np.nonzero(deg > 0)[0], n)
    off = (rng.random(n) * deg[cur]).astype(np.int64)
    prev = graph.indices.cpu().numpy()[indptr[cur] + off].astype(np.int64)
    prev[::7] = -1
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(
        graph.indptr.device)
    keys = t(rng.integers(0, 1 << 32, (n, 2)))
    return t(cur), t(prev), t(rng.integers(0, 5, n)), keys


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["node2vec", "metapath", "deepwalk"])
def test_generated_kernels_choose_as_the_hand_rules(cuda_device, name):
    graph = power_law_graph(4000, 10, seed=1).to(cuda_device)
    hand = make_workload(name)
    gen = stripped(hand)
    cur, prev, step, keys = _walkers(graph, 4096, 2)
    for jump in (False, True):
        a, b = (ervs_select(graph, p, p.params(), cur, prev, step, keys,
                            tile=256, jump=jump) for p in (hand, gen))
        assert torch.equal(a, b), (name, jump)
    bound = torch.full(cur.shape, 2.0, device=cuda_device)
    outs = [erjs_select(graph, p, p.params(), cur, prev, step, keys, bound)
            for p in (hand, gen)]
    for a, b in zip(*outs):
        assert torch.equal(a, b), name
    if name == "deepwalk":
        eng = WalkEngine(graph, gen, EngineConfig(method="erjs",
                                                  step_exec="fused"))
        state = WalkerState.create(cur, key_data(3))
        args = dict(kind="rejection", tile=256, rjs_trials=8,
                    rjs_max_rounds=16, epoch_len=8, num_steps=80,
                    bmax=eng._fused_bmax)
        a = megastep.fused_epoch(graph, hand, (), state, **args)
        b = megastep.fused_epoch(graph, gen, (), state, **args)
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.cuda
def test_quickstart_program_runs_adaptive_on_the_card(cuda_device):
    graph = power_law_graph(4000, 10, seed=1).to(cuda_device)
    prog = degree_damped()
    eng = WalkEngine(graph, prog, EngineConfig(method="adaptive",
                                               jump_threshold=8))
    assert eng.compiled.flag == "PER_STEP" and eng.precomp is None
    build.reset_launches()
    res = eng.run(np.arange(4000), num_steps=12)
    assert build.LAUNCHES["erjs_select"] > 0
    assert build.LAUNCHES["ervs_select"] + build.LAUNCHES[
        "ervs_jump_select"] > 0
    assert (res.paths[:, 1:] >= 0).sum(axis=1).max() == 9
    cur, prev, step, keys = _walkers(graph, 4096, 4)
    ws = prog.init_wstate_batch(torch.arange(4096, device=cuda_device))
    bound = eng.sampler_ctx.estimates(WalkerState(
        cur=cur, prev=prev, step=step, alive=torch.ones_like(
            cur, dtype=torch.bool), rng=keys, wstate=ws)).bound_max
    got = erjs_select(graph, prog, (), cur, prev, step, keys, bound)
    want = erjs_mod.erjs_step(graph, prog, (), cur, prev, step, keys, bound)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_unlowerable_weights_raise_on_the_card(cuda_device):
    graph = power_law_graph(500, 6, seed=1).to(cuda_device)
    sort = WalkProgram(
        name="sorted", init=lambda: (),
        get_weight=lambda c, p, ws: torch.sort(
            torch.stack([c.h, c.h * 2], dim=-1), dim=-1).values[..., 0])
    eng = WalkEngine(graph, sort, EngineConfig(method="adaptive"))
    assert eng.compiled.flag == "FALLBACK"
    with pytest.raises(ValueError, match="sort"):
        eng.run(np.arange(50), num_steps=3)
    visited = make_workload("visited_avoiding")
    eng = WalkEngine(graph, stripped(visited), EngineConfig(method="ervs"))
    with pytest.raises(ValueError, match="wstate"):
        eng.run(np.arange(50), num_steps=3)
