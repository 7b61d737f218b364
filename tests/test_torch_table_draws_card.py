"""K3, K5 and K4's table instances on the card, on the rows their table
layouts treat apart.

K3 searches the fence table (``PrecompTables.its_fence``) and counts
inside one 16-entry CDF block; K5 and K4's alias instance read the pair
table (``PrecompTables.alias_pair``).  Each is held bit for bit against
its plain PyTorch version on the same card tensors, on
``table_rows_graph``'s rows (starts at every residue mod 32, rows of 1 to
33 entries and of 70,000, zero-weight plateaus across block boundaries,
empty and zero-total rows, integer weights) with random keys and keys
whose target rounds to the total; K4 with every third row stale, 16
steps.  Every test needs the card (``cuda`` marker); this file imports no
JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import (TABLE_ROW_KINDS, cuda_device,  # noqa: F401
                         one_torch_thread, table_rows_graph, table_walkers)
from repro_torch import interop
from repro_torch.core import build_tables, precomp
from repro_torch.core.types import WalkerState
from repro_torch.kernels import build, megastep
from repro_torch.kernels.alias import alias_pick
from repro_torch.kernels.its import its_search
from repro_torch.walks import make_workload


def _rows(kind, dev, name="deepwalk"):
    """(graph, program ``name``'s tables, walkers, keys) on ``dev``."""
    arrays = table_rows_graph(kind, 40)
    g = interop.graph_from_arrays(*arrays, device=dev)
    pw = make_workload(name)
    tables = build_tables(g, pw, pw.params())
    cur, kd = table_walkers(arrays[0], 8, 41)
    return (g, tables, torch.from_numpy(cur).to(dev),
            interop.keys_from_arrays(kd, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TABLE_ROW_KINDS)
def test_k3_matches_plain_version(kind, cuda_device):
    g, tables, cur, keys = _rows(kind, cuda_device)
    build.reset_launches()
    got = its_search(g, tables, cur, keys)
    assert build.LAUNCHES["its_search"] == 1
    want = precomp.its_offsets(g, tables, cur, keys)
    assert torch.equal(got, want)
    assert bool((want == -1).any()) and bool((want > 100).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TABLE_ROW_KINDS)
def test_k5_matches_plain_version(kind, cuda_device):
    g, tables, cur, keys = _rows(kind, cuda_device)
    build.reset_launches()
    got = alias_pick(g, tables, cur, keys)
    assert build.LAUNCHES["alias_pick"] == 1
    assert torch.equal(got, precomp.alias_offsets(g, tables, cur, keys))


@pytest.mark.cuda
def test_k3_refuses_an_unaligned_cdf(cuda_device):
    """The kernel reads the CDF 16 B at a time: a CDF that starts between
    two 16 B boundaries is refused, not read misaligned."""
    g, tables, cur, keys = _rows("plain", cuda_device)
    E = g.num_edges
    shifted = torch.empty(E + 1, dtype=torch.float32, device=cuda_device)
    shifted[1:] = tables.cdf
    bad = dataclasses.replace(tables, cdf=shifted[1:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        its_search(g, bad, cur, keys)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["precomp_its", "precomp_alias"])
@pytest.mark.parametrize("name", ["deepwalk", "ppr_nibble"])
@pytest.mark.parametrize("kind", TABLE_ROW_KINDS)
def test_k4_tables_with_stale_rows_match_plain_version(kind, name, regime,
                                                       cuda_device):
    g, tables, cur, keys = _rows(kind, cuda_device, name)
    pw = make_workload(name)
    p = pw.params()
    invalid = tables.invalid.clone()
    invalid[::3] = True
    W = cur.numel()
    gen = np.random.default_rng(42)
    alive = torch.ones(W, dtype=torch.bool, device=cuda_device)
    alive[::11] = False
    state = WalkerState(
        cur=cur, prev=torch.full_like(cur, -1),
        step=torch.from_numpy(gen.integers(0, 80, W)).to(cuda_device),
        alive=alive, rng=keys,
        wstate=pw.init_wstate_batch(torch.arange(W, device=cuda_device)))
    args = dict(kind=regime, tile=256, rjs_trials=8, rjs_max_rounds=16,
                epoch_len=16, num_steps=80,
                tables=dataclasses.replace(tables, invalid=invalid))
    got = megastep.fused_epoch(g, pw, p, state, **args)
    want = megastep.fused_epoch_plain(g, pw, p, state, **args)
    (s1, e1, f1), (s2, e2, f2) = got, want
    assert torch.equal(e1, e2) and torch.equal(f1, f2)
    for f in ("cur", "prev", "step", "alive"):
        assert torch.equal(getattr(s1, f), getattr(s2, f))
    for a, b in zip(s1.wstate or (), s2.wstate or ()):
        assert torch.equal(a, b)
    assert bool(((f2 >> 3) & 1).any()) and bool(((f2 >> 4) & 1).any())
