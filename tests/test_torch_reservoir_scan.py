"""Port parity: the plain reservoir scan on hand-built rows.

The scan of plain K1 and of K4's reservoir regime (``csrc/ervs.cuh``)
steps through the logical tile by counters, folds tile keys once per warp
and computes the exact key only where a bound says it may win.  Its plain
version, ``core.ervs.ervs_step``, is held here against the reference's
``ervs_step`` on rows of 1 to 70,000 edges whose starts take every
alignment mod 4 (``scan_rows_graph``), with h of 0, subnormal, 1e30 and
+inf among ordinary values, at tiles 2, 3, 32, 256 and 1,024: the same
next node, except where the decision compares two float32 keys within
2 ulp (checked in float64); on rows where keys tie exactly (+inf weights,
keys of -0.0) and on rows without a positive weight (-1), bit for bit.
The reference runs on XLA's CPU, which reads subnormal floats as zero, so
the all-subnormal rows are held only on the card
(``test_torch_reservoir_scan_card.py``), against this plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (node_offsets, one_torch_thread,  # noqa: F401
                         scan_rows_graph, scan_walkers)
from repro.core.ervs import ervs_step as ref_ervs_step
from repro.graphs.csr import CSRGraph as RefGraph
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import ervs as ervs_mod
from repro_torch.walks import make_workload

TILES = (2, 3, 32, 256, 1024)
KINDS = ("plain", "mixed", "ties", "dead")


@pytest.fixture(scope="module")
def rows():
    indptr, indices, h, labels, nodes, kinds = scan_rows_graph(3, KINDS)
    cur, prev, step, kd = scan_walkers(indptr, indices, nodes, 2, 4)
    return dict(
        ref=RefGraph(indptr=jnp.asarray(indptr), indices=jnp.asarray(indices),
                     h=jnp.asarray(h), labels=jnp.asarray(labels)),
        port=interop.graph_from_arrays(indptr, indices, h, labels),
        indptr=indptr, indices=indices, cur=cur, prev=prev, step=step, kd=kd,
        kind=np.repeat(kinds, 2))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def test_rows_cover_lengths_alignments_and_weights(rows):
    indptr = rows["indptr"].astype(np.int64)
    cur = rows["cur"]
    deg = indptr[cur + 1] - indptr[cur]
    assert deg.min() == 1 and deg.max() == 70_000
    assert set(indptr[cur] % 4) == {0, 1, 2, 3}
    h = np.asarray(rows["port"].h)
    for v in (0.0, 1e30, np.inf):
        assert (h == np.float32(v)).any()
    assert ((h > 0) & (h < np.finfo(np.float32).tiny)).any()


@pytest.mark.parametrize("program", ["deepwalk", "node2vec", "metapath"])
@pytest.mark.parametrize("tile", TILES)
def test_plain_scan_matches_reference(rows, program, tile):
    wl, pw = ref_make_workload(program), make_workload(program)
    cur, prev, step, kd = (rows[k] for k in ("cur", "prev", "step", "kd"))
    j = lambda a: jnp.asarray(a, jnp.int32)
    want = np.asarray(ref_ervs_step(
        rows["ref"], wl, wl.params(), j(cur), j(prev), j(step),
        jax.random.wrap_key_data(jnp.asarray(kd)), tile=tile))
    keys = interop.keys_from_arrays(kd)
    got = ervs_mod.ervs_step(rows["port"], pw, pw.params(), _t(cur),
                             _t(prev), _t(step), keys, tile=tile).numpy()
    if pw.weighted:
        exact = np.isin(rows["kind"], ("ties", "dead"))
        assert np.array_equal(got[exact], want[exact])
        assert (got[rows["kind"] == "dead"] == -1).all()
    bad = np.nonzero(got != want)[0]
    if bad.size:
        args = [rows["port"], pw, pw.params(), _t(cur[bad]), _t(prev[bad]),
                _t(step[bad]), keys[bad]]
        offs = [_t(node_offsets(rows["indptr"], rows["indices"], cur[bad],
                                x[bad])) for x in (got, want)]
        ka, kb = (ervs_mod.offset_keys_f64(*args, o, tile) for o in offs)
        near = ervs_mod.within_ulps(ka, kb).numpy()
        assert near.all(), f"divergences beyond the near-tie contract at " \
                           f"walkers {bad[~near].tolist()}"
    assert (got >= 0).sum() > 0.5 * got.size
