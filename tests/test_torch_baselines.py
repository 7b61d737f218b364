"""Port parity, part 16: the Table 2 baseline samplers' step functions
(``repro_torch/core/baselines.py``, the plain versions of K9–K12).

* ``its_step``, ``rvs_prefix_step``, ``rjs_maxreduce_step`` and
  ``als_step`` against the reference's on the same keys, bit for bit, on
  node2vec, metapath, 2ndpr, deepwalk and visited_avoiding (whose rings
  the weights read): rows of 1 to 24 neighbours with zero-weight runs, a
  star row of 5,000 (four levels of the base-16 scan), an empty row, and
  keys whose ITS target lies within an ulp of the total (ALS on the small
  rows only: the reference's build loop costs pad² a walker);
* the padding invariance K9–K12 rest on: each plain version gives the
  same bits at ``pad`` and at ``4 * pad``;
* K9's arithmetic as the kernel runs it (``_torch_port.its_row_model``:
  the levels of the walker's own row, the prefix at ``pad - 1``, the
  padded positions' groups) against ``ref.xla_cumsum`` of the padded row;
* ``ref.xla_tree_sum`` against ``jnp.sum`` at widths beyond one tile.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (baseline_rows_graph, baseline_walkers,  # noqa: F401
                         its_row_model, one_torch_thread)
from repro.core import baselines as ref_baselines
from repro.graphs.csr import CSRGraph as RefCSRGraph
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import baselines
from repro_torch.kernels.ref import xla_cumsum, xla_tree_sum
from repro_torch.walks import make_workload

PROGRAMS = ["node2vec", "metapath", "2ndpr", "deepwalk", "visited_avoiding"]
STAR_PAD, SMALL_PAD = 8192, 32
N_WALKERS = 160


def _case(star: bool, name: str):
    """(reference args, port args, pad) of N_WALKERS walkers: graph,
    program, params, cur, prev, step, keys — and each side's wstate."""
    arrays = baseline_rows_graph(11, star=star)
    cur, prev, step, kd, ring = baseline_walkers(arrays[0], arrays[1],
                                                 N_WALKERS, 12)
    rg = RefCSRGraph(*(jnp.asarray(a) for a in arrays))
    pg = interop.graph_from_arrays(*arrays)
    wl, pw = ref_make_workload(name), make_workload(name)
    i32 = lambda a: jnp.asarray(a, jnp.int32)
    i64 = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    ref = (rg, wl, wl.params(), i32(cur), i32(prev), i32(step),
           jnp.asarray(kd))
    port = (pg, pw, pw.params(), i64(cur), i64(prev), i64(step),
            interop.keys_from_arrays(kd))
    ws = (None, None)
    if name == "visited_avoiding":
        ws = (jnp.asarray(ring), interop.wstate_from_arrays(ring))
    return ref, port, ws, STAR_PAD if star else SMALL_PAD


STEP_FNS = {"its": "its_step", "rvs_prefix": "rvs_prefix_step",
            "rjs_maxreduce": "rjs_maxreduce_step", "als": "als_step"}
CASES = [(m, n) for m in ("its", "rvs_prefix", "rjs_maxreduce")
         for n in PROGRAMS] + [("als", n) for n in PROGRAMS]


@pytest.mark.parametrize("method,name", CASES)
def test_step_matches_reference(method, name):
    star = method != "als"
    ref, port, (ref_ws, port_ws), pad = _case(star, name)
    extra = ({"trials_per_round": 2, "max_rounds": 2}
             if method == "rjs_maxreduce" else {})
    want = getattr(ref_baselines, STEP_FNS[method])(
        *ref, pad=pad, wstate=ref_ws, **extra)
    got = getattr(baselines, STEP_FNS[method])(*port, pad, wstate=port_ws,
                                               **extra)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    moved = got.numpy() >= 0
    assert 0.5 < moved.mean() < 1.0  # the empty row and zero rows give -1
    if star:  # the star row's walkers moved along it
        assert moved[::10].mean() > 0.5


@pytest.mark.parametrize("method", list(STEP_FNS))
@pytest.mark.parametrize("name", ["node2vec", "visited_avoiding"])
def test_plain_versions_do_not_depend_on_pad(method, name):
    _, port, (_, ws), pad = _case(method != "als", name)
    # 60 walkers: the six top keys, six on the star row, six just off it
    port = port[:3] + tuple(x[:60] for x in port[3:])
    ws = None if ws is None else tuple(x[:60] for x in ws)
    fn = getattr(baselines, STEP_FNS[method])
    extra = ({"trials_per_round": 1, "max_rounds": 1}
             if method == "rjs_maxreduce" else {})
    a = fn(*port, pad, wstate=ws, **extra)
    b = fn(*port, 4 * pad, wstate=ws, **extra)
    assert torch.equal(a, b)
    if method != "als":
        bound = baselines.row_max(*port[:6], pad, wstate=ws)
        assert torch.equal(bound, baselines.row_max(*port[:6], 4 * pad,
                                                    wstate=ws))


@pytest.mark.parametrize("seed", range(6))
def test_its_row_model_matches_xla_cumsum(seed):
    """The kernel's scan of the walker's own row gives the padded scan's
    prefixes, its last one, and how many padded prefixes lie at or below
    any target (targets: every padded value, each an ulp lower, and the
    row's last prefix)."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        pad = int(2 ** rng.integers(4, 12))
        n = int(rng.choice([1, 15, 16, 17, 256, 257, pad // 2 + 3, pad - 1,
                            pad, int(rng.integers(1, pad + 1))]))
        n = min(max(n, 1), pad)
        w = (rng.pareto(1.0, n) * (rng.random(n) < 0.7)).astype(np.float32)
        padded = np.zeros(pad, np.float32)
        padded[:n] = w
        cs = xla_cumsum(torch.from_numpy(padded)[None])[0].numpy()
        prefixes, total, groups = its_row_model(w, pad)
        np.testing.assert_array_equal(np.array(prefixes, np.float32),
                                      cs[:n])
        assert total == cs[-1]
        assert sum(c for _, c in groups) == pad - n
        tail = cs[n:]
        for r in set(tail.tolist()) | {float(cs[n - 1])}:
            for t in (np.float32(r), np.nextafter(np.float32(r),
                                                  np.float32(0))):
                assert sum(c for v, c in groups if v <= t) == \
                    int((tail <= t).sum())


def test_xla_tree_sum_matches_jnp_sum():
    """At power-of-two widths beyond one tile, rows ending in zeros too
    (a row shorter than pad)."""
    rng = np.random.default_rng(3)
    for m in (32, 64, 1024, 8192, 1 << 15):
        w = (rng.pareto(1.0, (4, m)) * (rng.random((4, m)) < 0.8)).astype(
            np.float32)
        w[1, m // 3:] = 0.0
        w[2, 40:] = 0.0
        want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=1))(w))
        got = xla_tree_sum(torch.from_numpy(w))
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.numpy().view(np.uint32))
        short = xla_tree_sum(torch.from_numpy(w[1:2, :max(m // 3, 1)]))
        assert short.numpy().view(np.uint32)[0] == want.view(np.uint32)[1]
