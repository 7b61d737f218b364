"""Plain K1 and K4's reservoir regime on the card, on hand-built rows.

Both run the plain reservoir scan of ``csrc/ervs.cuh``; here each is held
against its plain PyTorch version on the same card tensors, on the rows
of ``scan_rows_graph`` (1 to 70,000 edges, starts at every alignment mod
4; h of 0, subnormal, 1e30 and +inf among ordinary values, many exact
ties at -0.0, rows without a positive weight, rows of subnormals only) at
tiles 2, 3, 32, 256 and 1,024: the same next node except at near-ties
(two float32 keys within 2 ulp, checked in float64), bit for bit on the
tie rows and the rows without a positive weight (for the weighted rules:
an unweighted rule reads no h).  K1 under every device
rule, K4 hook-free (deepwalk) and hooked (ppr_nibble), one step, its flag
words and end state bit for bit where the node is the same.  Every test
needs the card (``cuda`` marker); this file imports no JAX.
"""
import numpy as np
import pytest
import torch

from _torch_port import (cuda_device, node_offsets,  # noqa: F401
                         one_torch_thread, scan_rows_graph, scan_walkers)
from repro_torch import interop
from repro_torch.core import ervs as ervs_mod
from repro_torch.core.types import WalkerState
from repro_torch.kernels import megastep
from repro_torch.kernels.ervs import ervs_select, kernel_rule
from repro_torch.kernels.prng import fold_in
from repro_torch.walks import make_workload

TILES = (2, 3, 32, 256, 1024)
PROGRAMS = ("deepwalk", "node2vec", "node2vec_unweighted", "metapath",
            "metapath_unweighted", "2ndpr", "visited_avoiding", "ppr_nibble")


@pytest.fixture(scope="module")
def rows():
    indptr, indices, h, labels, nodes, kinds = scan_rows_graph(5)
    cur, prev, step, kd = scan_walkers(indptr, indices, nodes, 2, 6)
    return dict(arrays=(indptr, indices, h, labels), indptr=indptr,
                indices=indices, cur=cur, prev=prev, step=step, kd=kd,
                kind=np.repeat(kinds, 2))


def _on(rows, dev):
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    return (interop.graph_from_arrays(*rows["arrays"], device=dev),
            t(rows["cur"]), t(rows["prev"]), t(rows["step"]),
            interop.keys_from_arrays(rows["kd"], device=dev))


def _wstate(pw, cur, indptr, indices):
    """The program's state for these walkers; a visited-avoiding ring holds
    the first neighbours of the walker's row (a tabu test that bites)."""
    ws = pw.init_wstate_batch(torch.arange(cur.numel(), device=cur.device))
    if ws and pw.name.startswith("visited"):
        ring = ws[0].clone()
        for i, c in enumerate(cur.tolist()):
            row = indices[indptr[c]:indptr[c + 1]][:ring.shape[1] // 2]
            ring[i, :row.size] = torch.from_numpy(row.astype(np.int32))
        ws = (ring,)
    return ws


def _check(rows, pg, pw, args, got, want, tile, ws=None):
    """Same next nodes but at near-ties; bitwise on the tie and dead rows
    of a weighted rule (an unweighted one reads no h)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if kernel_rule(pw, pw.params()).weighted:
        exact = np.isin(rows["kind"], ("ties", "dead"))
        assert np.array_equal(got[exact], want[exact])
        assert (got[rows["kind"] == "dead"] == -1).all()
    bad = np.nonzero(got != want)[0]
    if bad.size:
        dev = args[0].device
        sel = torch.from_numpy(bad).to(dev)
        sub = [a[sel] for a in args]
        ws_bad = tuple(x[sel] for x in ws) if ws else ws
        offs = [torch.from_numpy(node_offsets(
            rows["indptr"], rows["indices"], rows["cur"][bad], x[bad])).to(dev)
            for x in (got, want)]
        ka, kb = (ervs_mod.offset_keys_f64(pg, pw, pw.params(), *sub, o, tile,
                                           ws_bad) for o in offs)
        near = ervs_mod.within_ulps(ka, kb).cpu().numpy()
        assert near.all(), f"divergences beyond the near-tie contract at " \
                           f"walkers {bad[~near].tolist()}"
    return bad.size


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
def test_k1_plain_scan_matches_plain_version(rows, tile, cuda_device):
    pg, cur, prev, step, keys = _on(rows, cuda_device)
    for name in PROGRAMS:
        pw = make_workload(name)
        p = pw.params()
        ws = _wstate(pw, cur, rows["indptr"], rows["indices"])
        got = ervs_select(pg, pw, p, cur, prev, step, keys, tile=tile,
                          wstate=ws)
        want = ervs_mod.ervs_step(pg, pw, p, cur, prev, step, keys,
                                  tile=tile, wstate=ws)
        _check(rows, pg, pw, (cur, prev, step, keys), got, want, tile, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", ["deepwalk", "ppr_nibble"])
def test_k4_reservoir_scan_matches_plain_version(rows, name, tile,
                                                 cuda_device):
    pg, cur, prev, step, stream = _on(rows, cuda_device)
    pw = make_workload(name)
    state = WalkerState(cur=cur, prev=prev, step=step,
                        alive=torch.ones_like(cur, dtype=torch.bool),
                        rng=stream,
                        wstate=_wstate(pw, cur, rows["indptr"],
                                       rows["indices"]))
    args = dict(kind="reservoir", tile=tile, rjs_trials=4, rjs_max_rounds=4,
                epoch_len=1, num_steps=80)
    got = megastep.fused_epoch(pg, pw, pw.params(), state, **args)
    want = megastep.fused_epoch_plain(pg, pw, pw.params(), state, **args)
    keys = fold_in(stream, step)
    _check(rows, pg, pw, (cur, prev, step, keys), got[1][:, 0].long(),
           want[1][:, 0].long(), tile)
    assert torch.equal(got[2], want[2])
    same = got[1][:, 0] == want[1][:, 0]
    for f in ("cur", "prev", "step", "alive"):
        assert torch.equal(getattr(got[0], f)[same], getattr(want[0], f)[same])
    for a, b in zip(got[0].wstate or (), want[0].wstate or ()):
        assert torch.equal(a[same], b[same])
