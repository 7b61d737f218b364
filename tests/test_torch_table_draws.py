"""Port parity: the table draws (K3's and K5's plain versions) on the rows
the CUDA draws treat apart.

K3 searches a fence table of every 16th CDF entry and then counts inside
one aligned 16-entry block; K5 reads a column's prob and alias as one
word.  Their plain versions (``core.precomp.its_offsets`` /
``alias_offsets``), which the card tests hold the kernels to, are held
here against the reference on ``table_rows_graph``'s rows: row starts at
every residue mod 16 and mod 32, rows of 1 to 33 entries and of 70,000,
zero-weight plateaus across block boundaries, rows sharing their first
block with the row before, empty and zero-total rows, integer weights
(targets on CDF values) and keys whose target rounds to the total.  Both
offsets (the reference's kernel oracles ``its_search_ref`` /
``alias_pick_ref`` on its aligned stream) and next nodes (its staged
draws ``its_select`` / ``alias_select``) must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (TABLE_ROW_KINDS, TOP_UNIFORM_KEYS,  # noqa: F401
                         one_torch_thread, table_rows_graph, table_walkers)
from repro.core import precomp as ref_precomp
from repro.graphs.csr import CSRGraph as RefGraph
from repro.kernels import prng as ref_prng
from repro.kernels import ref as ref_kernels
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import build_tables, precomp
from repro_torch.core.precomp import FENCE_BLOCK, ITS_SALT
from repro_torch.kernels import prng
from repro_torch.walks import make_workload


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module", params=TABLE_ROW_KINDS)
def rows(request):
    arrays = table_rows_graph(request.param, 30)
    g = RefGraph(*(jnp.asarray(a) for a in arrays))
    ref_tables = ref_precomp.build_tables(g, ref_make_workload("deepwalk"),
                                          (), aligned=True)
    pg = interop.graph_from_arrays(*arrays)
    pw = make_workload("deepwalk")
    tables = build_tables(pg, pw, pw.params())
    cur, kd = table_walkers(arrays[0], 6, 31)
    indptr = arrays[0].astype(np.int64)
    return dict(kind=request.param, ref_graph=g, ref_tables=ref_tables,
                graph=pg, tables=tables, cur=cur, kd=kd, indptr=indptr,
                deg=np.diff(indptr))


def _ref_inputs(r):
    """The reference's (row starts in the aligned stream, degrees,
    totals, Threefry seeds) of the walkers."""
    vs = jnp.asarray(r["cur"], jnp.int32)
    t = r["ref_tables"]
    seeds = ref_precomp.threefry_seeds(
        jax.random.wrap_key_data(jnp.asarray(r["kd"])))
    return t.arow0[vs], jnp.asarray(r["deg"][r["cur"]], jnp.int32), \
        t.total[vs], seeds


def test_tables_bitwise(rows):
    t, got = rows["ref_tables"], rows["tables"]
    assert np.array_equal(_bits(t.cdf), _bits(got.cdf))
    assert np.array_equal(_bits(t.total), _bits(got.total))
    assert np.array_equal(np.asarray(t.alias_off), got.alias_off.numpy())
    assert np.array_equal(_bits(t.alias_prob), _bits(got.alias_prob))


def test_its_offsets_match_reference(rows):
    r = rows
    keys = interop.keys_from_arrays(r["kd"])
    got = precomp.its_offsets(r["graph"], r["tables"],
                              torch.from_numpy(r["cur"]), keys).numpy()
    row0, deg, total, seeds = _ref_inputs(r)
    want = ref_kernels.its_search_ref(r["ref_tables"].cdf2d, row0, deg,
                                      total, seeds)
    assert np.array_equal(np.asarray(want), got)
    nodes = precomp.its_select(r["graph"], r["tables"],
                               torch.from_numpy(r["cur"]), keys,
                               active=torch.ones(r["cur"].size, dtype=bool))
    want_nodes = ref_precomp.its_select(
        r["ref_graph"], r["ref_tables"], jnp.asarray(r["cur"], jnp.int32),
        jax.random.wrap_key_data(jnp.asarray(r["kd"])),
        active=jnp.ones(r["cur"].size, bool), depth=32)
    assert np.array_equal(np.asarray(want_nodes), nodes.numpy())
    # the cases the fence search treats apart are all there
    u = prng.uniform_01(keys[:, 0], keys[:, 1], 0, ITS_SALT)
    tot = r["tables"].total[torch.from_numpy(r["cur"])]
    target = (u * tot).numpy()
    cdf = r["tables"].cdf.numpy()
    s = r["indptr"][r["cur"]]
    d = r["deg"][r["cur"]]
    ok = (d > 0) & (tot.numpy() > 0)
    assert bool(((target == tot.numpy()) & ok).any())
    assert not (got[~ok] != -1).any() and (~ok).any()
    assert set(s[ok & (d > 1) & (d < 100)] % 32) == set(range(32))
    # the chosen block: the first past the row's first block, or the last
    # of a row of many blocks
    blk = (s + np.maximum(got, 0)) // FENCE_BLOCK
    assert ((blk > s // FENCE_BLOCK) & ok).any()
    assert ((blk == (s + d - 1) // FENCE_BLOCK) & ok & (d > 100)).any()
    if r["kind"] == "integer":  # targets on CDF values, inside rows
        on = ok & (got > 0) & (got < d - 1)
        assert (target[on] == cdf[s[on] + got[on] - 1]).any()
    if r["kind"] == "plateaus":  # plateaus across a block boundary
        z = r["graph"].h.numpy() == 0.0
        last = z[FENCE_BLOCK - 1::FENCE_BLOCK]  # a block's last entry
        first = z[FENCE_BLOCK::FENCE_BLOCK]  # the next block's first
        assert (last[:first.size] & first).any()


def test_alias_offsets_match_reference(rows):
    r = rows
    keys = interop.keys_from_arrays(r["kd"])
    got = precomp.alias_offsets(r["graph"], r["tables"],
                                torch.from_numpy(r["cur"]), keys).numpy()
    row0, deg, total, seeds = _ref_inputs(r)
    t = r["ref_tables"]
    want = ref_kernels.alias_pick_ref(t.prob2d, t.alias2d, row0, deg, total,
                                      seeds)
    assert np.array_equal(np.asarray(want), got)
    nodes = precomp.alias_select(r["graph"], r["tables"],
                                 torch.from_numpy(r["cur"]), keys,
                                 active=torch.ones(r["cur"].size,
                                                   dtype=bool))
    want_nodes = ref_precomp.alias_select(
        r["ref_graph"], t, jnp.asarray(r["cur"], jnp.int32),
        jax.random.wrap_key_data(jnp.asarray(r["kd"])),
        active=jnp.ones(r["cur"].size, bool))
    assert np.array_equal(np.asarray(want_nodes), nodes.numpy())
    # both branches of the draw: the column kept and its alias taken
    u1, _ = prng.uniform_pair_01(keys[:, 0], keys[:, 1], 0,
                                 precomp.ALIAS_SALT)
    d = rows["deg"][r["cur"]]
    col = np.minimum((u1.numpy() * d.astype(np.float32)).astype(np.int64),
                     np.maximum(d - 1, 0))
    ok = got >= 0
    assert (got[ok] == col[ok]).any() and (got[ok] != col[ok]).any()


def test_draw_layouts(rows):
    """The fence and pair tables the CUDA draws read, from the fields."""
    t = rows["tables"]
    E = t.cdf.numel()
    fence = t.its_fence
    assert fence.shape == (E // FENCE_BLOCK,) and fence.is_contiguous()
    assert torch.equal(fence, t.cdf[FENCE_BLOCK - 1::FENCE_BLOCK])
    pair = t.alias_pair
    assert pair.shape == (E, 2) and pair.dtype == torch.int32
    assert torch.equal(pair[:, 0].contiguous().view(torch.float32),
                       t.alias_prob)
    assert torch.equal(pair[:, 1], t.alias_off)
    assert t.its_fence is fence  # built once per tables object


@pytest.mark.parametrize("k0,k1", TOP_UNIFORM_KEYS)
def test_top_uniform_keys(k0, k1):
    """The keys ``table_walkers`` hands every row draw the largest ITS
    uniforms there are, in the port and in the reference."""
    want = ref_prng.uniform_01(jnp.uint32(k0), jnp.uint32(k1), jnp.uint32(0),
                               jnp.uint32(ITS_SALT))
    got = prng.uniform_01(torch.tensor([k0]), torch.tensor([k1]), 0,
                          ITS_SALT)
    assert _bits(want) == _bits(got.numpy())[0]
    assert float(want) >= 1.0 - 2.0 / (1 << 24)
