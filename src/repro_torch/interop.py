"""Bring the reference's objects into the port, handed over as numpy
arrays (this module imports nothing of the reference: the caller passes
``np.asarray`` of each field).

Used by the tests to feed the reference and the port the same graph,
statistics, tables, walker state (the sampler carry included) and model
parameters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.precomp import PrecompTables
from repro_torch.core.samplers import PrefetchTile
from repro_torch.core.types import WalkerState, WalkProgram
from repro_torch.graphs.csr import CSRGraph, NodeStats
from repro_torch.models import DecoderLM, ModelConfig, segment_plan
from repro_torch.walks.workloads import make_workload


def _t(a, dtype, device):
    return torch.from_numpy(np.array(a)).to(
        device=device, dtype=dtype)


def graph_from_arrays(indptr, indices, h, labels, device="cpu") -> CSRGraph:
    return CSRGraph(indptr=_t(indptr, torch.int32, device),
                    indices=_t(indices, torch.int32, device),
                    h=_t(h, torch.float32, device),
                    labels=_t(labels, torch.int32, device))


def stats_from_arrays(h_min, h_max, h_sum, h_mean, degree, label_count,
                      device="cpu") -> NodeStats:
    return NodeStats(h_min=_t(h_min, torch.float32, device),
                     h_max=_t(h_max, torch.float32, device),
                     h_sum=_t(h_sum, torch.float32, device),
                     h_mean=_t(h_mean, torch.float32, device),
                     degree=_t(degree, torch.int32, device),
                     label_count=_t(label_count, torch.int32, device))


def tables_from_arrays(cdf, total, invalid, device="cpu", *, alias_off=None,
                       alias_prob=None) -> PrecompTables:
    """The reference's ``PrecompTables``: the flat arrays, the ``invalid``
    bitmap and, when given, the alias tables."""
    opt = lambda a, dtype: None if a is None else _t(a, dtype, device)
    return PrecompTables(cdf=_t(cdf, torch.float32, device),
                         total=_t(total, torch.float32, device),
                         alias_off=opt(alias_off, torch.int32),
                         alias_prob=opt(alias_prob, torch.float32),
                         invalid=_t(invalid, torch.bool, device))


def state_from_arrays(cur, prev, step, alive, rng, device="cpu",
                      carry=None) -> WalkerState:
    """``rng`` is the reference's raw uint32 key data [W, 2]; ``carry``, a
    sampler carry already in the port's form (:func:`carry_from_arrays`),
    or None."""
    return WalkerState(cur=_t(cur, torch.int64, device),
                       prev=_t(prev, torch.int64, device),
                       step=_t(step, torch.int64, device),
                       alive=_t(alive, torch.bool, device),
                       rng=_t(np.asarray(rng, np.uint32).astype(np.int64),
                              torch.int64, device), carry=carry)


def carry_from_arrays(node, nbr, h, label, device="cpu") -> PrefetchTile:
    """The reference's ``PrefetchTile`` (the ``interleaved`` sampler's
    carry), its four leaves as numpy arrays, as the port's: ``node`` int64,
    ``nbr`` / ``h`` / ``label`` int32 / float32 / int32."""
    return PrefetchTile(node=_t(node, torch.int64, device),
                        nbr=_t(nbr, torch.int32, device),
                        h=_t(h, torch.float32, device),
                        label=_t(label, torch.int32, device))


def keys_from_arrays(key_data, device="cpu") -> torch.Tensor:
    """Raw uint32 key data [..., 2] as the port's int64 keys."""
    return _t(np.asarray(key_data, np.uint32).astype(np.int64), torch.int64,
              device)


def wstate_from_arrays(leaves, device="cpu"):
    """The reference's per-walker program state — its pytree leaves as
    numpy arrays, in ``jax.tree_util.tree_leaves`` order (one array for a
    one-leaf state, None when stateless) — as the port's tuple."""
    if leaves is None:
        return None
    if not isinstance(leaves, (list, tuple)):
        leaves = [leaves]
    return tuple(torch.from_numpy(np.array(leaf)).to(device)
                 for leaf in leaves)


def program_from_params(name: str, params=None, weighted: bool = True
                        ) -> WalkProgram:
    """The port's program for a reference registry name and its
    hyperparameters: the reference's params dataclass (``N2VParams``,
    ``MetaPathParams``, ...), a dict of factory keywords, or None for the
    defaults.  ``weighted`` is ignored for the ``*_unweighted`` names."""
    if params is None or params == ():
        kw = {}
    elif dataclasses.is_dataclass(params):
        kw = dataclasses.asdict(params)
    else:
        kw = dict(params)
    if not name.endswith("_unweighted"):
        kw["weighted"] = weighted
    return make_workload(name, **kw)


@torch.no_grad()
def params_from_arrays(cfg: ModelConfig, params, device="cuda") -> DecoderLM:
    """The port's model holding the reference's ``init_params`` pytree,
    given as the same nested dicts with numpy leaves (bf16 leaves as
    float32, which is lossless).  Each segment's ``[reps, ...]`` leaves are
    unstacked into its layers; weights are cast to ``cfg.dtype`` and the
    float32 head is built."""
    model = DecoderLM(cfg, device)

    def put(p: torch.Tensor, a) -> None:
        p.copy_(torch.from_numpy(np.array(a, np.float32)))

    put(model.embed, params["embed"])
    put(model.final_norm, params["final_norm"])
    if model.lm_head is not None:
        put(model.lm_head, params["lm_head"])
    for (kinds, _), blocks, seg in zip(segment_plan(cfg), model.segments,
                                       params["segments"]):
        tree = seg[f"b0_{kinds[0]}"]
        for r, blk in enumerate(blocks):
            put(blk.norm1, tree["norm1"][r])
            put(blk.norm2, tree["norm2"][r])
            for sub in ("attn", "mlp"):
                for name, p in getattr(blk, sub).named_parameters():
                    put(p, tree[sub][name][r])
    model.build_head()
    return model
