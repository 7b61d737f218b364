"""Port parity, the jump reservoir on hub rows (K1 jump's plain version).

A-ExpJ magnifies a 1-ulp change: ``log(u2)`` of a ``u2`` near 1 turns it
into a relative change of the next threshold, which moves later crossings
far from any near-tie.  So on long rows the plain ``ervs_jump_step`` must
run the reference's arithmetic as XLA on the CPU compiles it: ``u2 = t_w +
u0 * (1 - t_w)`` as one fused multiply-add, and XLA's exp and log.  The
rows of ``tests/test_torch_regimes.py`` (at most a few dozen weights) are
too short to show a difference; here 4,096 walkers per program sit on the
8 largest rows of a 20,000-node power-law graph (1,436 to 3,454 weights,
tile 16, so each lane runs ~100-200 A-ExpJ items) and every one of them
must take the reference's choice.  At tiles 2 and 1,024 (a lane runs
~700-1,700 items, or the row is a single tile) node2vec and 2ndpr, whose
rules test dist(v', u) against the previous node's row, are held the same
way on every eighth walker.

On the card (``cuda`` marker; skips here) K1 jump must equal its plain
version bitwise at tiles 2, 16, 256 and 1,024 under node2vec, 2ndpr and
visited_avoiding, with previous nodes of every kind the kernel's cursor
meets: none (-1), a neighbour on a short row, another hub, and the largest
row (its cursor gallops).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (cuda_device, one_torch_thread,  # noqa: F401
                         random_keys, to_port_graph)
from repro.core.ervs import ervs_jump_step as ref_ervs_jump_step
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import ervs as ervs_mod
from repro_torch.kernels.ervs import ervs_select
from repro_torch.walks import make_workload

TILE = 16
HUBS = 8
WALKERS = 4096


@pytest.fixture(scope="module")
def hubs():
    """Walkers on the largest rows, each with a random neighbour as its
    previous node (-1 for every tenth), and random per-step keys."""
    g = ref_power_law(20_000, 14, seed=0)
    indptr = np.asarray(g.indptr, np.int64)
    indices = np.asarray(g.indices, np.int64)
    deg = np.diff(indptr)
    top = np.argsort(-deg, kind="stable")[:HUBS]
    rng = np.random.default_rng(3)
    cur = np.repeat(top, WALKERS // HUBS)
    prev = indices[indptr[cur] + (rng.random(cur.size) * deg[cur]).astype(
        np.int64)]
    prev[::10] = -1
    step = rng.integers(0, 40, cur.size)
    return dict(g=g, pg=to_port_graph(g), cur=cur, prev=prev, step=step,
                kd=random_keys(cur.size, 5), rows=deg[top], top=top)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def test_hub_rows_are_long(hubs):
    assert hubs["rows"].min() == 1436 and hubs["rows"].max() == 3454


@pytest.mark.parametrize("program", ["deepwalk", "node2vec"])
def test_jump_step_on_hub_rows_equals_reference(hubs, program):
    wl, pw = ref_make_workload(program), make_workload(program)
    cur, prev, step, kd = (hubs[k] for k in ("cur", "prev", "step", "kd"))
    i32 = lambda a: jnp.asarray(a, jnp.int32)
    want, _ = ref_ervs_jump_step(hubs["g"], wl, wl.params(), i32(cur),
                                 i32(prev), i32(step),
                                 jax.random.wrap_key_data(jnp.asarray(kd)),
                                 tile=TILE)
    got = ervs_mod.ervs_jump_step(hubs["pg"], pw, pw.params(), _t(cur),
                                  _t(prev), _t(step),
                                  interop.keys_from_arrays(kd), tile=TILE)
    diverged = np.nonzero(got.numpy() != np.asarray(want))[0]
    assert diverged.size == 0, f"{diverged.size} of {cur.size} walkers " \
                               f"diverge: {diverged[:10].tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["deepwalk", "node2vec"])
def test_jump_kernel_on_hub_rows_equals_plain(hubs, program, cuda_device):
    """K1 jump runs the same arithmetic, so it equals its plain version
    bitwise on the same card tensors."""
    pw = make_workload(program)
    pg = hubs["pg"].to(cuda_device)
    cur, prev, step = (_t(hubs[k]).to(cuda_device)
                       for k in ("cur", "prev", "step"))
    keys = interop.keys_from_arrays(hubs["kd"], device=cuda_device)
    got = ervs_select(pg, pw, pw.params(), cur, prev, step, keys, tile=TILE,
                      jump=True)
    want = ervs_mod.ervs_jump_step(pg, pw, pw.params(), cur, prev, step, keys,
                                   tile=TILE)
    assert torch.equal(got, want)


def _ref_jump(hubs, program, tile, sel):
    wl = ref_make_workload(program)
    i32 = lambda a: jnp.asarray(a[sel], jnp.int32)
    want, _ = ref_ervs_jump_step(hubs["g"], wl, wl.params(), i32(hubs["cur"]),
                                 i32(hubs["prev"]), i32(hubs["step"]),
                                 jax.random.wrap_key_data(jnp.asarray(
                                     hubs["kd"][sel])), tile=tile)
    return np.asarray(want)


@pytest.mark.parametrize("tile", [2, 1024])
@pytest.mark.parametrize("program", ["node2vec", "2ndpr"])
def test_jump_step_at_tile_on_hub_rows_equals_reference(hubs, program, tile):
    sel = slice(None, None, 8)
    pw = make_workload(program)
    got = ervs_mod.ervs_jump_step(
        hubs["pg"], pw, pw.params(), _t(hubs["cur"][sel]),
        _t(hubs["prev"][sel]), _t(hubs["step"][sel]),
        interop.keys_from_arrays(hubs["kd"][sel]), tile=tile)
    want = _ref_jump(hubs, program, tile, sel)
    diverged = np.nonzero(got.numpy() != want)[0]
    assert diverged.size == 0, f"{diverged.size} of {want.size} walkers " \
                               f"diverge: {diverged[:10].tolist()}"


def _prev_kinds(hubs):
    """The hub walkers' previous nodes with every kind mixed in: -1 (every
    tenth, as built), another hub, and the largest row."""
    prev = hubs["prev"].copy()
    top = np.asarray(hubs["top"])
    prev[1::10] = top[0]
    prev[2::10] = top[1 + np.arange(prev[2::10].size) % (top.size - 1)]
    return prev


def _rings(hubs, pw, n):
    """Visited rings holding a few of each walker's own neighbours."""
    g = hubs["g"]
    indptr = np.asarray(g.indptr, np.int64)
    indices = np.asarray(g.indices, np.int64)
    ring = pw.init_wstate_batch(torch.arange(n))[0].clone()
    rng = np.random.default_rng(6)
    deg = indptr[hubs["cur"] + 1] - indptr[hubs["cur"]]
    for k in range(min(5, ring.shape[1])):
        off = (rng.random(n) * deg).astype(np.int64)
        ring[:, k] = torch.from_numpy(indices[indptr[hubs["cur"]] + off])
    return (ring.contiguous(),)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [2, 16, 256, 1024])
@pytest.mark.parametrize("program", ["node2vec", "2ndpr", "visited_avoiding"])
def test_jump_kernel_prev_kinds_equals_plain(hubs, program, tile,
                                             cuda_device):
    pw = make_workload(program)
    n = hubs["cur"].size
    pg = hubs["pg"].to(cuda_device)
    cur, prev, step = (_t(a).to(cuda_device) for a in (
        hubs["cur"], _prev_kinds(hubs), hubs["step"]))
    keys = interop.keys_from_arrays(hubs["kd"], device=cuda_device)
    ws = None
    if program == "visited_avoiding":
        ws = tuple(x.to(cuda_device) for x in _rings(hubs, pw, n))
    got = ervs_select(pg, pw, pw.params(), cur, prev, step, keys, tile=tile,
                      jump=True, wstate=ws)
    want = ervs_mod.ervs_jump_step(pg, pw, pw.params(), cur, prev, step, keys,
                                   tile=tile, wstate=ws)
    assert torch.equal(got, want)
