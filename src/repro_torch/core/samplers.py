"""Sampler protocol, registry and the runtime adaptation (port of
``repro/core/samplers.py``).

The engine resolves ``EngineConfig.method`` through the registry and calls
``sampler.select(ctx, state, keys, active=live)`` once per step.  The port
registers ``adaptive``, ``ervs``, ``ervs_jump``, ``erjs``, ``its_precomp``,
``alias_precomp``, the Fig. 13 selector baselines ``random`` and
``degree`` (a coin flip, and rejection for rows of at least
``EngineConfig.degree_threshold``: eRJS or plain eRVS, no tables, no jump
reservoir, staged only), and the Table 2 baseline systems ``its``
(C-SAW), ``als`` (Skywalker), ``rvs_prefix`` (FlowWalker) and
``rjs_maxreduce`` (NextDoor) through :class:`PaddedRowSampler` (kernels
K9–K12, staged only), and ``interleaved`` (:class:`InterleavedSampler`:
eRVS with a cross-step prefetch of the next node's first tile, K1's
interleaved entry, staged only).  ``Sampler.fused_kind`` names the
fused-epoch regime (``kernels/megastep.FUSED_KINDS``) that reproduces a
sampler bit for bit, or None when it has none and must run staged.

:class:`PartitionedSampler` is the paper's runtime adaptation (§4.1,
§5.2): per node, precomp > rejection > reservoir.  Static rows draw from
the ITS tables (K3), the Eq. 11 cost model sends the rest to eRJS (K2) or
the reservoir, and the reservoir splits by degree — hubs
(deg ≥ ``jump_threshold``) take the A-ExpJ jump instance of K1, everyone
else plain eRVS.  Rejection lanes unresolved after the last round fall
back to the reservoir (§7.1).  Each regime runs on the compacted list of
its own lanes, with the lanes' rows of the program state (``wstate``); a
walker's draw never depends on the others, so this equals the
reference's masked full-width calls.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import flexi_compiler as fc
from repro_torch.core import precomp as precomp_mod
from repro_torch.core.ctxutil import degrees_of
from repro_torch.core.precomp import PrecompTables, offset_nodes
from repro_torch.core.types import WalkerState, wstate_rows
from repro_torch.kernels.alias import alias_pick
from repro_torch.kernels.baselines import BASELINE_SELECT_FNS
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.erjs import erjs_select
from repro_torch.kernels.ervs import ervs_interleaved_select, ervs_select
from repro_torch.kernels.its import its_search
from repro_torch.kernels.prng import fold_in, random_bits, uniform_from_bits


@dataclasses.dataclass(frozen=True)
class SamplerCaps:
    needs_precomp: bool = False  # wants ITS tables for static programs
    needs_alias: bool = False  # wants the Vose alias tables as well
    # reads whole rows as the reference's [W, pad] weight block (the plain
    # versions build the block; the kernels read each walker's own row):
    # the engine fills SamplerContext.pad only for such samplers
    needs_padded_row: bool = False


@dataclasses.dataclass(frozen=True)
class Estimates:
    bound_max: torch.Tensor  # [W] upper bound of max w̃ (Eqs. 5–8)
    sum_est: torch.Tensor  # [W] estimate of Σ w̃ (Eq. 12)


@dataclasses.dataclass
class Selection:
    """Result of one ``select``: next nodes [W] (-1 = dead end; inactive
    lanes junk), the regime counters over active lanes, and the sampler's
    cross-step carry, which the engine stores in ``WalkerState.carry``
    for the next step (None: carries nothing)."""

    next_nodes: torch.Tensor
    rjs_served: torch.Tensor
    fallbacks: torch.Tensor
    precomp_served: torch.Tensor
    stale_served: torch.Tensor
    carry: Any = None


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=like.device)


@dataclasses.dataclass(frozen=True)
class SamplerContext:
    """Per-engine inputs shared by every sampler."""

    graph: object  # CSRGraph
    workload: object  # WalkProgram
    params: object
    compiled: fc.CompiledWorkload
    stats: object  # NodeStats
    config: object  # EngineConfig
    # padded row width: a power of two holding every row (WalkEngine.pad)
    # for a sampler whose caps name needs_padded_row, else 0
    pad: int = 0
    precomp: Optional[PrecompTables] = None

    def bound_inputs(self, state: WalkerState) -> fc.BoundInputs:
        vs = state.cur.clamp_min(0)
        return fc.BoundInputs(
            h_min=self.stats.h_min[vs], h_max=self.stats.h_max[vs],
            h_mean=self.stats.h_mean[vs],
            deg_cur=degrees_of(self.graph, state.cur),
            deg_prev=degrees_of(self.graph, state.prev),
            cur=state.cur, prev=state.prev, step=state.step,
            wstate=state.wstate)

    def estimates(self, state: WalkerState) -> Estimates:
        if not self.compiled.usable:
            z = torch.zeros(state.cur.shape[0], device=state.cur.device)
            return Estimates(bound_max=z, sum_est=z)
        bi = self.bound_inputs(state)
        return Estimates(bound_max=self.compiled.bound_fn(bi),
                         sum_est=self.compiled.sum_fn(bi))


class Sampler(abc.ABC):
    """One sampling strategy: pick the next node for a batch of walkers."""

    name: str
    caps: SamplerCaps = SamplerCaps()

    @abc.abstractmethod
    def select(self, ctx: SamplerContext, state: WalkerState,
               keys: torch.Tensor, *, active: torch.Tensor) -> Selection:
        """Next nodes for the ``active`` lanes; ``keys`` [W, 2] are the
        per-walker, per-step keys."""

    def init_carry(self, ctx: SamplerContext, num_slots: int) -> Any:
        """Initial value of the sampler's cross-step carry
        (``WalkerState.carry``) for ``num_slots`` slots; a sampler that
        pipelines across steps (``interleaved``) overrides it, the default
        carries nothing.  Every leaf of a carry keeps the slot dimension
        first."""
        return None

    def fused_kind(self, *, usable: bool, has_precomp: bool
                   ) -> Optional[str]:
        """The fused-epoch regime that reproduces this sampler bit for
        bit, or None (staged only).  ``usable``: the compiler has a bound
        and sum for the program; ``has_precomp``: tables are baked."""
        return None


_REGISTRY: Dict[str, Sampler] = {}


def register_sampler(sampler: Sampler, *, overwrite: bool = False) -> Sampler:
    if sampler.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"sampler {sampler.name!r} already registered by "
            f"{type(_REGISTRY[sampler.name]).__name__} (pass "
            f"overwrite=True to replace); registered samplers: "
            f"{', '.join(available_samplers())}")
    _REGISTRY[sampler.name] = sampler
    return sampler


def get_sampler(name: str) -> Sampler:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sampler {name!r}; registered: "
                       f"{available_samplers()}") from None


def available_samplers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _lanes(mask: torch.Tensor) -> torch.Tensor:
    return mask.nonzero().squeeze(1)


def _reservoir(ctx, state, keys, mask, *, jump: bool) -> torch.Tensor:
    """Next nodes [W] from K1 on the lanes of ``mask`` (-1 elsewhere)."""
    nxt = torch.full_like(state.cur, -1)
    idx = _lanes(mask)
    if idx.numel():
        nxt[idx] = ervs_select(
            ctx.graph, ctx.workload, ctx.params, state.cur[idx],
            state.prev[idx], state.step[idx], keys[idx],
            tile=ctx.config.tile, jump=jump,
            wstate=wstate_rows(state.wstate, idx))
    return nxt


class ERVSSampler(Sampler):
    """eRVS — streaming exponential-key reservoir (paper §3.2)."""

    name = "ervs"
    jump = False

    def select(self, ctx, state, keys, *, active):
        z = _zero(state.cur)
        return Selection(_reservoir(ctx, state, keys, active, jump=self.jump),
                         z, z, z, z)

    def fused_kind(self, *, usable, has_precomp):
        return None if self.jump else "reservoir"


class ERVSJumpSampler(ERVSSampler):
    """eRVS + A-ExpJ jumps — RNG draws only at threshold crossings."""

    name = "ervs_jump"
    jump = True


class ERJSRejection:
    """eRJS — bound-based rejection trials (paper §3.3), the rejection half
    of a :class:`PartitionedSampler`."""

    def propose(self, ctx, state, keys, bound, active
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(next_nodes [W], needs_fallback [W] bool) over ``active`` lanes."""
        nxt = torch.full_like(state.cur, -1)
        fb = torch.zeros_like(active)
        idx = _lanes(active)
        if idx.numel():
            nxt[idx], fb[idx], _ = erjs_select(
                ctx.graph, ctx.workload, ctx.params, state.cur[idx],
                state.prev[idx], state.step[idx], keys[idx], bound[idx],
                trials=ctx.config.rjs_trials, rounds=ctx.config.rjs_max_rounds,
                wstate=wstate_rows(state.wstate, idx))
        return nxt, fb


# A policy maps (ctx, state, est, deg, active, keys) -> bool [W]: which of
# the active lanes go to the rejection partition this step (``keys``: the
# per-walker, per-step keys [W, 2]).
SelectorPolicy = Callable[..., torch.Tensor]
# fold-in constant of the random policy's coin (the reference's)
RANDOM_POLICY_SALT = 777


def cost_model_policy(ctx, state, est, deg, active, keys):
    """Eq. 11: rejection wins when ratio·max-bound < Σ-estimate."""
    return ctx.config.cost_model.prefer_rjs(est.bound_max, est.sum_est, deg)


def always_policy(ctx, state, est, deg, active, keys):
    """All-rejection (the pure ``erjs`` method); needs a usable bound."""
    if not ctx.compiled.usable:
        return torch.zeros_like(active)
    return torch.ones_like(active)


def random_policy(ctx, state, est, deg, active, keys):
    """Coin-flip selection (Fig. 13 baseline): ``jax.random.bernoulli`` at
    p = 0.5 of ``fold_in(key, 777)`` — its uniform below 0.5."""
    bits = random_bits(fold_in(keys, RANDOM_POLICY_SALT))
    coin = uniform_from_bits(bits, minval=0.0, maxval=1.0) < 0.5
    return coin & (est.bound_max > 0)


def degree_policy(ctx, state, est, deg, active, keys):
    """Degree-threshold selection (Fig. 13 baseline): rejection for rows of
    at least ``EngineConfig.degree_threshold``."""
    return (deg >= ctx.config.degree_threshold) & (est.bound_max > 0)


@dataclasses.dataclass
class Partition:
    """How :meth:`PartitionedSampler.partition` split the active lanes."""

    deg: torch.Tensor  # [W] degree of each lane's node
    est: Estimates
    want_pre: torch.Tensor  # [W] bool — served from the ITS tables
    stale_pre: torch.Tensor  # [W] bool — precomp-eligible but row stale
    want_rjs: torch.Tensor  # [W] bool — sent to eRJS by the policy


class PartitionedSampler(Sampler):
    """Runtime adaptation: precomp > rejection > reservoir per node, with
    the rejection→reservoir fallback and the reservoir's degree split."""

    def __init__(self, name: str, policy: SelectorPolicy, *,
                 precomp_regime: bool = False, jump_reservoir: bool = False):
        self.name = name
        self.policy = policy
        self.rejection = ERJSRejection()
        self.precomp_regime = precomp_regime
        self.jump_reservoir = jump_reservoir
        self.caps = SamplerCaps(needs_precomp=precomp_regime)

    def partition(self, ctx, state, active, keys) -> Partition:
        """Split the ``active`` lanes; ``keys`` are the per-step keys [W, 2]
        the policy may draw from."""
        deg = degrees_of(ctx.graph, state.cur)
        est = ctx.estimates(state)
        if self.precomp_regime and ctx.precomp is not None:
            prefer = ctx.config.cost_model.prefer_precomp(
                deg, frac_stale=ctx.precomp.frac_stale())
            valid = ctx.precomp.row_valid(state.cur)
            want_pre = active & valid & prefer
            stale_pre = active & ~valid & prefer
        else:
            want_pre = torch.zeros_like(active)
            stale_pre = torch.zeros_like(active)
        rest = active & ~want_pre
        want_rjs = self.policy(ctx, state, est, deg, rest, keys) & rest
        return Partition(deg, est, want_pre, stale_pre, want_rjs)

    def reservoir_split(self, ctx, part: Partition, res_active):
        """(plain lanes, jump lanes) of the reservoir partition."""
        if not self.jump_reservoir:
            return res_active, torch.zeros_like(res_active)
        hi = res_active & (part.deg >= ctx.config.jump_threshold)
        return res_active & ~hi, hi

    def fused_kind(self, *, usable, has_precomp):
        # only the plain all-rejection composition ("erjs": always_policy,
        # stock eRJS, no jump split, no precomp partition) has a fused
        # regime; without a usable bound every lane takes the reservoir
        if not (self.policy is always_policy
                and type(self.rejection) is ERJSRejection
                and not self.jump_reservoir and not self.precomp_regime):
            return None
        return "rejection" if usable else "reservoir"

    def select(self, ctx, state, keys, *, active):
        part = self.partition(ctx, state, active, keys)
        nxt_pre = precomp_table_select(ctx, state, keys, part.want_pre,
                                       kind="its")
        rest = active & ~part.want_pre
        nxt_rjs, fb = self.rejection.propose(ctx, state, keys,
                                             part.est.bound_max,
                                             part.want_rjs)
        res_active = rest & (~part.want_rjs | fb)
        lo, hi = self.reservoir_split(ctx, part, res_active)
        nxt_res = torch.where(
            hi, _reservoir(ctx, state, keys, hi, jump=True),
            _reservoir(ctx, state, keys, lo, jump=False))
        nxt = torch.where(res_active, nxt_res,
                          torch.where(part.want_rjs, nxt_rjs, -1))
        nxt = torch.where(part.want_pre, nxt_pre, nxt)
        return Selection(
            next_nodes=nxt,
            rjs_served=(part.want_rjs & ~fb & (nxt_rjs >= 0)
                        & ~part.stale_pre).sum(),
            fallbacks=fb.sum(),
            precomp_served=(part.want_pre & (nxt_pre >= 0)).sum(),
            stale_served=(part.stale_pre & (nxt >= 0)).sum())


# Execution paths of the table draws (EngineConfig.precomp_exec), the
# reference's choices under the port's names: "flat" (the reference's
# "jnp") draws through the engine entries of K3 / K5 on the flat [E]
# tables and their node records; "aligned" (the reference's "pallas")
# through the aligned entries (``kernels/ops.py`` ``its_search`` /
# ``alias_pick``) on the tile-aligned [R, 128] streams
# (``PrecompTables.with_aligned``); "auto" resolves to "flat".  Both draw
# from the same Threefry (key, counter, salt) triples, so the choice never
# changes an output bit.
PRECOMP_EXEC_CHOICES = ("auto", "flat", "aligned")


def resolve_precomp_exec(choice: str) -> str:
    """``auto`` → "flat", the entries every engine has run on the card."""
    return "flat" if choice == "auto" else choice


def precomp_table_select(ctx: SamplerContext, state: WalkerState,
                         keys: torch.Tensor, active: torch.Tensor, *,
                         kind: str) -> torch.Tensor:
    """Next nodes [W] for the ``active`` lanes from the baked tables
    (``kind``: "its", kernel K3, or "alias", kernel K5), through the entry
    ``EngineConfig.precomp_exec`` resolves to; -1 elsewhere and for empty
    or zero-total rows.  Under "aligned" a missing aligned stream raises
    (it never falls back to the flat entries)."""
    nxt = torch.full_like(state.cur, -1)
    tables = ctx.precomp
    aligned = resolve_precomp_exec(ctx.config.precomp_exec) == "aligned"
    if aligned:
        needed = (("arow0", "cdf2d") if kind == "its"
                  else ("arow0", "prob2d", "alias2d"))
        missing = [f for f in needed if getattr(tables, f) is None]
        if missing:
            raise RuntimeError(
                f"precomp_exec resolved to 'aligned' for kind={kind!r} but "
                f"the aligned table stream(s) {missing} are absent. "
                f"Re-attach via PrecompTables.with_aligned(indptr) (the "
                f"engine's precomp setter does), or run with "
                f"precomp_exec='flat'.")
    idx = _lanes(active)
    if not idx.numel():
        return nxt
    cur = state.cur[idx]
    if aligned:
        deg = degrees_of(ctx.graph, cur).to(torch.int32)
        seeds = precomp_mod.threefry_seeds(keys[idx]).contiguous()
        row0 = tables.arow0[cur]
        totals = tables.total[cur]
        if kind == "its":
            off = kernel_ops.its_search(tables.cdf2d, row0, deg, totals,
                                        seeds)
        else:
            off = kernel_ops.alias_pick(tables.prob2d, tables.alias2d, row0,
                                        deg, totals, seeds)
        nxt[idx] = offset_nodes(ctx.graph, cur, off.long())
        return nxt
    draw = its_search if kind == "its" else alias_pick
    nxt[idx] = offset_nodes(ctx.graph, cur,
                            draw(ctx.graph, tables, cur, keys[idx]))
    return nxt


class _PrecompBase(Sampler):
    """The C-SAW-style precomputed samplers: with baked tables (the program
    is static), valid rows draw from them and stale rows take eRVS over
    the live graph, counted in ``stale_served``; without tables the
    sampler is eRVS for good (``frac_precomp == 0``)."""

    caps = SamplerCaps(needs_precomp=True)
    kind = "its"  # the table family select() draws from

    def __init__(self):
        self._fallback = ERVSSampler()

    def select(self, ctx, state, keys, *, active):
        z = _zero(state.cur)
        if ctx.precomp is None:  # program not static: eRVS for good
            dyn = self._fallback.select(ctx, state, keys, active=active)
            return Selection(dyn.next_nodes, z, z, z, z)
        ok = active & ctx.precomp.row_valid(state.cur)
        nxt_pre = precomp_table_select(ctx, state, keys, ok, kind=self.kind)
        stale = active & ~ok
        dyn = self._fallback.select(ctx, state, keys, active=stale)
        nxt = torch.where(ok, nxt_pre, torch.where(stale, dyn.next_nodes, -1))
        # both count only lanes whose draw produced a transition
        return Selection(
            next_nodes=nxt, rjs_served=z, fallbacks=z,
            precomp_served=(ok & (nxt_pre >= 0)).sum(),
            stale_served=(stale & (dyn.next_nodes >= 0)).sum())

    def fused_kind(self, *, usable, has_precomp):
        # stale rows take the fused regime's reservoir; without tables the
        # sampler is eRVS, which the reservoir regime is
        return f"precomp_{self.kind}" if has_precomp else "reservoir"


class ITSPrecompSampler(_PrecompBase):
    """``its_precomp`` — O(log d) binary search of the baked row CDF."""

    name = "its_precomp"
    kind = "its"


class AliasPrecompSampler(_PrecompBase):
    """``alias_precomp`` — O(1) draw from the baked Vose alias tables."""

    caps = SamplerCaps(needs_precomp=True, needs_alias=True)
    name = "alias_precomp"
    kind = "alias"


class PaddedRowSampler(Sampler):
    """Adapter of the §2.2 baselines (ITS / ALS / prefix-RVS / max-reduce
    RJS): each pays a full pass over the walker's row every step.
    ``step_fn(graph, program, params, cur, prev, step, keys, pad=,
    wstate=, **extra)`` is a wrapper of ``kernels/baselines.py``, run on
    the compacted active lanes; ``extra_of_cfg`` maps keyword names to
    functions of the engine config (e.g. ``trials_per_round=lambda cfg:
    cfg.rjs_trials``).  The counters stay 0, as the reference counts."""

    caps = SamplerCaps(needs_padded_row=True)

    def __init__(self, name: str, step_fn: Callable, **extra_of_cfg):
        self.name = name
        self._step_fn = step_fn
        self._extra_of_cfg = extra_of_cfg

    def select(self, ctx, state, keys, *, active):
        nxt = torch.full_like(state.cur, -1)
        idx = _lanes(active)
        if idx.numel():
            extra = {k: f(ctx.config) for k, f in self._extra_of_cfg.items()}
            nxt[idx] = self._step_fn(
                ctx.graph, ctx.workload, ctx.params, state.cur[idx],
                state.prev[idx], state.step[idx], keys[idx], pad=ctx.pad,
                wstate=wstate_rows(state.wstate, idx), **extra)
        z = _zero(state.cur)
        return Selection(nxt, z, z, z, z)


@dataclasses.dataclass
class PrefetchTile:
    """The ``interleaved`` sampler's cross-step carry: the first neighbour
    tile of the node each slot is about to occupy, gathered by the step
    that chose it.  Every leaf leads with the slot dimension.

    ``node`` [W] int64 is the node the row was gathered for (-1: none);
    ``nbr`` / ``h`` / ``label`` [W, tile] (int32 / float32 / int32, the
    graph's own dtypes, which K1 reads) hold its offsets [0, tile) as the
    program reads them (h 1 for an unweighted program, label 0 for one
    without labels).  On the card only the first ``min(deg(node), tile)``
    entries of a row are written: the rest are unspecified, and nothing
    reads them (tile 0's mask is ``offset < deg``).  The plain version
    writes the reference's fills there (nbr -1, h 0, label -1 or 0), so
    whole arrays compare on the CPU."""

    node: torch.Tensor
    nbr: torch.Tensor
    h: torch.Tensor
    label: torch.Tensor


class InterleavedSampler(Sampler):
    """``interleaved`` — the ThunderRW-style gather-move-update pipeline:
    plain eRVS, bit for bit (the same per-tile uniforms and log-key
    arg-max), with tile 0 of a walker's row read from the prefetch that
    the previous step gathered (:class:`PrefetchTile`, in
    ``WalkerState.carry``), and this step's chosen node's first tile
    gathered behind the move.

    Correctness never rests on the prefetch: a lane whose carry tag is
    not its current node (first step, refill, dead end) reads the graph,
    and a tile gathered for node v is valid for any lane at v because the
    graph does not change within a run.  Kernel K1's interleaved entry
    (``kernels/ervs.py`` ``ervs_interleaved_select``) runs it on the card.
    No fused regime reproduces it: it always runs staged."""

    name = "interleaved"

    def init_carry(self, ctx, num_slots):
        tile, dev = ctx.config.tile, ctx.graph.device
        return PrefetchTile(
            node=torch.full((num_slots,), -1, dtype=torch.int64, device=dev),
            nbr=torch.full((num_slots, tile), -1, dtype=torch.int32,
                           device=dev),
            h=torch.zeros((num_slots, tile), dtype=torch.float32,
                          device=dev),
            label=torch.zeros((num_slots, tile), dtype=torch.int32,
                              device=dev))

    def select(self, ctx, state, keys, *, active):
        carry = state.carry
        if carry is None:  # nothing prefetched: every lane misses
            carry = self.init_carry(ctx, state.cur.shape[0])
        nxt = torch.full_like(state.cur, -1)
        idx = _lanes(active)
        nxt[idx] = ervs_interleaved_select(
            ctx.graph, ctx.workload, ctx.params, state.cur[idx],
            state.prev[idx], state.step[idx], keys[idx], carry, idx,
            tile=ctx.config.tile, wstate=wstate_rows(state.wstate, idx))
        z = _zero(state.cur)
        return Selection(nxt, z, z, z, z, carry=carry)


register_sampler(PartitionedSampler("adaptive", cost_model_policy,
                                    precomp_regime=True, jump_reservoir=True))
register_sampler(ERVSSampler())
register_sampler(ERVSJumpSampler())
register_sampler(PartitionedSampler("erjs", always_policy))
_BASELINE_CFG_KW = {
    "rjs_maxreduce": dict(trials_per_round=lambda cfg: cfg.rjs_trials,
                          max_rounds=lambda cfg: 4 * cfg.rjs_max_rounds),
}
for _name, _fn in BASELINE_SELECT_FNS.items():
    register_sampler(PaddedRowSampler(_name, _fn,
                                      **_BASELINE_CFG_KW.get(_name, {})))
register_sampler(PartitionedSampler("random", random_policy))
register_sampler(PartitionedSampler("degree", degree_policy))
register_sampler(ITSPrecompSampler())
register_sampler(AliasPrecompSampler())
register_sampler(InterleavedSampler())
