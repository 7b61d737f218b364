"""Flexi-Runtime — the walk engine (port of ``repro/core/runtime.py``;
paper §4.1, §5.2, §5.3).

``WalkEngine.run`` drives the streaming epoch scheduler: a fixed pool of
walker slots runs ``epoch_len`` steps at a time, and between epochs the
slots whose walker finished are refilled from a host-side queue.  Each
step folds the walker's step count into its per-query stream key, masks
the live lanes (alive ∧ degree > 0 ∧ step < L), calls the sampler, and
records :class:`StepStats` over live lanes only.  Random streams are keyed
per query (``fold_in(key, query_id)``), so paths and telemetry are
identical for any ``batch`` / ``epoch_len``.

An epoch runs one of two ways (``EngineConfig.step_exec``), with the same
paths and telemetry bit for bit: "staged", a Python loop of steps whose
regimes are the CUDA kernels K1–K3 and K5 on the card (the reference's
jitted ``lax.scan``), or "fused", the whole epoch in one launch of K4
(``kernels/megastep.py``, the reference's mega-step) when the (sampler ×
program) cell has a fused regime.  A program's per-walker state rides in
``WalkerState.wstate``: each refill installs the query's
``init_walker_state``, each step commits ``on_step`` on the lanes that
moved and folds ``should_stop`` into ``alive``.  A sampler's cross-step
state rides in ``WalkerState.carry`` (the ``interleaved`` sampler's
prefetch tile), which refills leave alone.

Beside ``run``, the scheduler is a library surface of its own:
``WalkEngine.scheduler()`` returns a long-lived :class:`EpochScheduler`
(``admit``, ``run_epoch``, ``kill``, ``occupancy``, ``in_flight``) that
serves every epoch from the table view pinned at its construction, or
re-pins each epoch with ``track_tables=True``; ``WalkEngine.walk_batch``
runs one fully occupied batch with no host scheduling.  Table draws go
through the flat or the aligned entries of K3 / K5
(``EngineConfig.precomp_exec``).  Multi-device runs, the mutation and
epoch clocks and graph updates wait for later slices.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import flexi_compiler as fc
from repro_torch.core import precomp as precomp_mod
from repro_torch.core.cost_model import CostModel
from repro_torch.core.ctxutil import (apply_hooks, degrees_of, eval_weights,
                                      tile_ctx, transition_ctx)
from repro_torch.core.samplers import (PRECOMP_EXEC_CHOICES, SamplerContext,
                                       available_samplers, get_sampler,
                                       resolve_precomp_exec)
from repro_torch.core.types import (StepStats, WalkerState, WalkProgram,
                                    from_workload)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph, node_stats
from repro_torch.kernels import megastep
from repro_torch.kernels.prng import key_data

DEFAULT_EPOCH_LEN = 16

# Step execution paths (EngineConfig.step_exec): "staged" = the step loop
# of WalkEngine.step; "fused" = one K4 launch per epoch for a cell with a
# fused regime; "auto" = fused on the card when the cell is fusable,
# staged on the CPU.  Both give the same bits; a cell with no fused regime
# keeps the staged loop (WalkEngine.step_exec_resolved says which ran).
STEP_EXEC_CHOICES = ("auto", "fused", "staged")
# the reference kernel's tile geometry (an even tile dividing 1024), kept
# so both packages resolve the same cells to the fused path
KERNEL_TILE = 1024


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    method: str = "adaptive"
    tile: int = 256
    rjs_trials: int = 8
    rjs_max_rounds: int = 16
    cost_model: CostModel = dataclasses.field(default_factory=CostModel)
    seed: int = 0
    # rows of at least this degree take eRJS under the "degree" selector
    # (Fig. 13 baseline)
    degree_threshold: int = 1024
    # degree at which the adaptive reservoir switches from plain eRVS to
    # the A-ExpJ jump variant
    jump_threshold: int = 1024
    # steps per scheduler epoch; None → one full-walk epoch when every
    # query has a slot, else min(walk length, 16)
    epoch_len: Optional[int] = None
    # where the engine runs: "cuda" (the kernels) or "cpu" (their plain
    # versions); "cuda" without a card raises
    device: str = "cuda"
    # step execution path: see STEP_EXEC_CHOICES
    step_exec: str = "auto"
    # execution path of the staged table draws: "flat" (the engine
    # entries of K3 / K5), "aligned" (their aligned entries on the
    # tile-aligned streams), "auto" = flat; the same bits either way
    # (samplers.PRECOMP_EXEC_CHOICES)
    precomp_exec: str = "auto"

    def __post_init__(self):
        if self.method not in available_samplers():
            raise ValueError(
                f"method {self.method!r} does not name a registered "
                f"sampler; known samplers: "
                f"{', '.join(available_samplers())}")
        if self.tile < 1:
            raise ValueError(f"tile must be positive, got {self.tile}")
        if self.precomp_exec not in PRECOMP_EXEC_CHOICES:
            raise ValueError(
                f"precomp_exec {self.precomp_exec!r} does not name a "
                f"table-draw execution path; valid choices: "
                f"{', '.join(PRECOMP_EXEC_CHOICES)}")
        if self.step_exec not in STEP_EXEC_CHOICES:
            raise ValueError(
                f"step_exec {self.step_exec!r} does not name a step "
                f"execution path; valid choices: "
                f"{', '.join(STEP_EXEC_CHOICES)}")


@dataclasses.dataclass
class WalkResult:
    paths: np.ndarray  # [Q, L+1] int32; -1 marks termination
    frac_rjs: float  # fraction of live steps served by eRJS
    rjs_fallbacks: int
    steps: int
    live_steps: int = 0
    frac_precomp: float = 0.0
    frac_stale: float = 0.0
    # host-clock seconds of run()'s phases: "setup" (queue order, path
    # matrix), "admit" (refills, until their device work is done),
    # "steps" (the step loop, until its telemetry is on the host) and
    # "harvest" (emitted entries copied into the path matrix)
    seconds: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class EpochReport:
    """What one scheduler epoch did."""

    completed: np.ndarray  # query ids whose walkers finished this epoch
    steps_taken: np.ndarray  # steps each completed query walked
    occupied: int  # slots occupied while the epoch ran
    stats: dict  # the epoch's StepStats.host_totals sums

    @property
    def walker_steps(self) -> int:
        """Live walker-steps this epoch served (the ``live`` sum): pad
        slots, finished walkers and dead lanes never count."""
        return int(self.stats.get("live", 0))


class EpochScheduler:
    """Host-side loop over the engine's epochs: a slot pool, refills at
    epoch boundaries (:meth:`admit`), lanes retired on demand
    (:meth:`kill`), and path harvesting.

    Query ids pick the RNG streams (``fold_in(key, qid)``) and the rows of
    :attr:`paths`, so a query's path does not depend on its slot or on
    when it was admitted.  Every epoch is served from the table view
    pinned at construction (:meth:`adopt_tables`), not from whatever
    ``engine.precomp`` holds later; ``track_tables=True`` re-pins it at
    the start of every epoch."""

    def __init__(self, engine: "WalkEngine", num_steps: int,
                 key: torch.Tensor, slots: int, epoch_len: int,
                 capacity: int = 0, track_tables: bool = False):
        self.engine = engine
        self.num_steps = int(num_steps)
        self.key = key
        self.W = int(slots)
        self.T = int(epoch_len)
        self.adopt_tables()
        self.track_tables = bool(track_tables)
        self.paths = np.full((int(capacity), self.num_steps + 1), -1,
                             np.int32)
        self.slot_query = np.full(self.W, -1, np.int64)
        self.totals = {"live": 0, "rjs_served": 0, "fallbacks": 0,
                       "precomp_served": 0, "stale_served": 0}
        # host-clock seconds per phase; see WalkResult.seconds
        self.seconds = {"admit": 0.0, "steps": 0.0, "harvest": 0.0}
        dev = engine.device
        self.state = WalkerState(
            cur=torch.zeros(self.W, dtype=torch.int64, device=dev),
            prev=torch.full((self.W,), -1, dtype=torch.int64, device=dev),
            step=torch.full((self.W,), self.num_steps, dtype=torch.int64,
                            device=dev),
            alive=torch.zeros(self.W, dtype=torch.bool, device=dev),
            rng=torch.zeros((self.W, 2), dtype=torch.int64, device=dev),
            carry=engine.sampler.init_carry(engine.sampler_ctx, self.W),
            # placeholder rows until a refill installs the query's own
            wstate=engine.workload.init_wstate_batch(
                torch.zeros(self.W, dtype=torch.int64, device=dev)))

    @property
    def busy(self) -> bool:
        return bool((self.slot_query >= 0).any())

    @property
    def occupancy(self) -> int:
        """Slots currently serving a query."""
        return int((self.slot_query >= 0).sum())

    def in_flight(self) -> np.ndarray:
        """Query ids currently occupying slots, in slot order."""
        return self.slot_query[self.slot_query >= 0].copy()

    def free_slots(self) -> np.ndarray:
        """Admittable slot indices, in slot order."""
        return np.nonzero(self.slot_query < 0)[0]

    def adopt_tables(self) -> None:
        """Pin this scheduler's view on the engine's current precomp
        tables, graph, node statistics and padded row width; every epoch
        is served from the view pinned last.  Called at construction and,
        under ``track_tables=True``, at the start of every epoch."""
        ctx = self.engine.sampler_ctx
        self.tables = ctx.precomp
        self.graph_view = ctx.graph
        self.stats_view = ctx.stats
        self.pad_view = ctx.pad

    def reset_sampler_carry(self) -> None:
        """Re-initialise the sampler's cross-step carry (the interleaved
        sampler's prefetch tile).  Bit-neutral while the graph is
        unchanged: a cold tile gathers the same values again."""
        eng = self.engine
        self.state = dataclasses.replace(
            self.state, carry=eng.sampler.init_carry(eng.sampler_ctx,
                                                     self.W))

    def _ensure_capacity(self, n: int) -> None:
        if n <= self.paths.shape[0]:
            return
        cap = max(n, 2 * self.paths.shape[0], 64)
        grown = np.full((cap, self.num_steps + 1), -1, np.int32)
        grown[:self.paths.shape[0]] = self.paths
        self.paths = grown

    def admit(self, query_ids, starts) -> int:
        """Install queries into free slots: ``step=0``, ``prev=-1``,
        ``alive=True``, the query's own stream key and its program state
        ``init_walker_state(query)``.  Returns how many were admitted."""
        qs = np.asarray(query_ids, np.int64).reshape(-1)
        if qs.size == 0:
            return 0
        t0 = time.perf_counter()
        starts = np.asarray(starts, np.int64).reshape(-1)
        free = self.free_slots()
        if qs.size > free.size:
            raise ValueError(
                f"admit() got {qs.size} queries but only {free.size} "
                f"slots are free; consult free_slots() first")
        self._ensure_capacity(int(qs.max()) + 1)
        self.paths[qs, 0] = starts
        take = free[:qs.size]
        self.slot_query[take] = qs
        dev = self.engine.device
        idx = torch.from_numpy(take).to(dev)
        s = self.state
        s.cur[idx] = torch.from_numpy(starts).to(dev)
        s.prev[idx] = -1
        s.step[idx] = 0
        s.alive[idx] = True
        qids = torch.from_numpy(qs).to(dev)
        s.rng[idx] = WalkerState.stream_key_data(self.key, qids)
        if s.wstate is not None:
            for leaf, new in zip(s.wstate,
                                 self.engine.workload.init_wstate_batch(qids)):
                leaf[idx] = new
        # the sampler's carry survives refills: a sampler validates it per
        # lane (a prefetch tile's tag is its node, so a new occupant misses)
        self.seconds["admit"] += time.perf_counter() - t0
        return int(qs.size)

    def kill(self, query_ids) -> np.ndarray:
        """Retire the lanes serving ``query_ids`` now: clear their
        ``alive`` bits (the walker emits nothing further and stops
        counting toward telemetry, as after a ``should_stop``) and free
        their slots for the next admission.  Harvested path prefixes stay
        in :attr:`paths`.  Returns the query ids found in flight."""
        qs = np.asarray(query_ids, np.int64).reshape(-1)
        idx_np = np.nonzero(np.isin(self.slot_query, qs))[0]
        killed = self.slot_query[idx_np].copy()
        if idx_np.size:
            idx = torch.from_numpy(idx_np).to(self.engine.device)
            self.state.alive[idx] = False
            self.slot_query[idx_np] = -1
        return killed

    def run_epoch(self) -> EpochReport:
        """Run ``T`` steps against the pinned table view (re-pinned first
        under ``track_tables``), harvest the emitted path entries, and
        report which queries completed."""
        t0 = time.perf_counter()
        if self.track_tables:
            self.adopt_tables()
        step0 = self.state.step.cpu().numpy()  # waits for the refills
        t1 = time.perf_counter()
        self.state, emitted, stats = self.engine.run_epoch_fn(
            self.state, self.tables, self.graph_view, self.stats_view,
            epoch_len=self.T, num_steps=self.num_steps, pad=self.pad_view)
        t2 = time.perf_counter()
        emitted = emitted.cpu().numpy()  # [W, T]
        step1 = self.state.step.cpu().numpy()
        alive1 = self.state.alive.cpu().numpy()
        occupied = np.nonzero(self.slot_query >= 0)[0]
        taken = step1[occupied] - step0[occupied]
        s0 = step0[occupied]
        if s0.size and (s0 == s0[0]).all():
            base = int(s0[0])
            width = min(self.T, self.num_steps - base)
            self.paths[self.slot_query[occupied], base + 1:base + 1 + width] \
                = emitted[occupied, :width]
        else:
            for t in range(int(taken.max(initial=0))):
                sel = occupied[taken > t]
                self.paths[self.slot_query[sel], step0[sel] + 1 + t] = \
                    emitted[sel, t]
        for k in self.totals:
            self.totals[k] += stats[k]
        done = occupied[(~alive1[occupied])
                        | (step1[occupied] >= self.num_steps)]
        completed = self.slot_query[done].copy()
        steps_taken = step1[done].copy()
        self.slot_query[done] = -1
        self.seconds["admit"] += t1 - t0
        self.seconds["steps"] += t2 - t1
        self.seconds["harvest"] += time.perf_counter() - t2
        return EpochReport(completed=completed, steps_taken=steps_taken,
                           occupied=int(occupied.size), stats=stats)


class WalkEngine:
    """End-to-end dynamic walk executor for one (graph, walk program) on
    ``config.device`` ("cuda" by default).  ``precomp``: tables already
    baked for this graph and program (another engine's), used in place of
    a build and laid out as the ``precomp`` setter lays them out."""

    def __init__(self, graph: CSRGraph, workload: WalkProgram,
                 config: Optional[EngineConfig] = None,
                 precomp: Optional[precomp_mod.PrecompTables] = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self.graph = graph.to(self.device)
        # a legacy Workload (or any object with its attributes) is adapted
        workload = from_workload(workload)
        self.workload = workload
        self.sampler = get_sampler(self.config.method)
        self.stats = node_stats(self.graph,
                                num_labels=max(workload.num_labels, 1))
        self.compiled = fc.analyze(workload)
        self.max_degree = self.graph.max_degree()
        # a power-of-two row width that holds every row (exact_probs)
        self.pad = max(1 << max(self.max_degree - 1, 0).bit_length(),
                       self.config.tile)
        # fused plan: a (sampler × program) cell runs as one K4 launch per
        # epoch when the program is fusable, the sampler names a fused
        # regime, and rejection's bound can be baked per node
        self.fuse = fc.fuse_report(workload)
        will_precomp = (self.sampler.caps.needs_precomp
                        and fc.is_static(workload))
        self._fused_kind = self._plan_fused_kind(will_precomp)
        params = workload.params()
        if will_precomp and precomp is None:
            precomp = precomp_mod.build_tables(
                self.graph, workload, params,
                alias=self.sampler.caps.needs_alias)
        self.sampler_ctx = SamplerContext(
            graph=self.graph, workload=workload, params=params,
            compiled=self.compiled, stats=self.stats, config=self.config,
            pad=self.pad if self.sampler.caps.needs_padded_row else 0,
            precomp=self._with_streams(precomp) if will_precomp else None)
        self._build_draw_layouts(self.sampler_ctx.precomp)
        self._fused_epoch_fn = (self._build_fused_epoch()
                                if self._fused_kind else None)
        self._fused_bmax = None
        self._refresh_fused_streams()

    @property
    def precomp(self) -> Optional[precomp_mod.PrecompTables]:
        """The baked tables every path draws from (None: not static)."""
        return self.sampler_ctx.precomp

    @precomp.setter
    def precomp(self, tables: precomp_mod.PrecompTables) -> None:
        """Swap in tables of the same graph and program, e.g. with rows
        marked stale in ``invalid``."""
        if self.sampler_ctx.precomp is None:
            raise ValueError(f"{self.workload.name} under "
                             f"{self.config.method!r} draws from no tables")
        tables = self._with_streams(tables)
        self._build_draw_layouts(tables)
        self.sampler_ctx = dataclasses.replace(self.sampler_ctx,
                                               precomp=tables)

    def _with_streams(self, tables):
        """``tables``, with the aligned streams attached when the table
        draws resolve to the aligned entries and they lack them."""
        if (resolve_precomp_exec(self.config.precomp_exec) == "aligned"
                and tables.arow0 is None):
            return tables.with_aligned(self.graph.indptr)
        return tables

    def _build_draw_layouts(self, tables) -> None:
        """On the card, build the table layouts the CUDA draws read (the
        node records and the fence table, and the pair table where there
        are alias tables) at set-up, so that no step pays for them."""
        if tables is None or self.device.type != "cuda":
            return
        tables.draw_rows(self.graph.indptr)
        tables.its_fence
        if tables.alias_off is not None:
            tables.alias_pair

    # ------------------------------------------------------ fused planning
    @property
    def step_exec_resolved(self) -> str:
        """The step execution path this engine runs: "fused" or "staged"."""
        return "fused" if self._fused_epoch_fn is not None else "staged"

    def _plan_fused_kind(self, will_precomp: bool) -> Optional[str]:
        """Resolve ``config.step_exec`` against the fusability facts: the
        fused regime to run, or None for the staged loop."""
        cfg = self.config
        if cfg.step_exec == "staged":
            return None
        if cfg.step_exec == "auto" and self.device.type != "cuda":
            return None  # the plain fused loop is a test vehicle, not a win
        if not self.fuse.fusable:
            return None
        kind = self.sampler.fused_kind(usable=self.compiled.usable,
                                       has_precomp=will_precomp)
        if kind is None:
            return None
        if kind == "rejection" and not self.fuse.bound_node_local:
            # K4 reads a per-node bound table; a bound that depends on the
            # walker's state cannot be baked.  Never downgrade to the
            # reservoir regime (other telemetry): stay staged.
            return None
        tile = cfg.tile
        if tile < 2 or tile % 2 or KERNEL_TILE % tile:
            return None
        return kind

    def _bake_bmax(self) -> torch.Tensor:
        """Per-node rejection bound table [V] for K4.  Sound because the
        plan requires ``fuse.bound_node_local``: the bound ignores prev,
        step and the program state, so evaluating it at a placeholder
        walker (state: ``wstate_template()``) gives every walker's bound
        at v."""
        V = self.graph.num_nodes
        dev = self.device
        template = self.workload.wstate_template(dev)
        ws = None if template is None else tuple(
            leaf.expand((V,) + leaf.shape) for leaf in template)
        bi = fc.BoundInputs(
            h_min=self.stats.h_min, h_max=self.stats.h_max,
            h_mean=self.stats.h_mean, deg_cur=self.graph.degrees().long(),
            deg_prev=torch.zeros(V, dtype=torch.int64, device=dev),
            cur=torch.arange(V, dtype=torch.int64, device=dev),
            prev=torch.full((V,), -1, dtype=torch.int64, device=dev),
            step=torch.zeros(V, dtype=torch.int64, device=dev), wstate=ws)
        return self.compiled.bound_fn(bi)

    def _build_fused_epoch(self):
        cfg = self.config
        return functools.partial(
            megastep.fused_epoch, self.graph, self.workload,
            self.sampler_ctx.params, kind=self._fused_kind, tile=cfg.tile,
            rjs_trials=cfg.rjs_trials, rjs_max_rounds=cfg.rjs_max_rounds)

    def _refresh_fused_streams(self) -> None:
        """(Re)bake what K4 reads beside the graph and the tables: the
        per-node bound table of the rejection regime."""
        self._fused_bmax = (self._bake_bmax()
                            if self._fused_kind == "rejection" else None)

    def step(self, state: WalkerState, num_steps: int, ctx=None
             ) -> Tuple[WalkerState, torch.Tensor, StepStats]:
        """One walk step of every slot: (new state, emitted [W], stats);
        ``ctx`` is the sampler context to step against (default the
        engine's own)."""
        ctx = ctx or self.sampler_ctx
        deg = degrees_of(ctx.graph, state.cur)
        wants = state.alive & (state.step < num_steps)
        live = wants & (deg > 0)
        keys = state.stream_keys()
        sel = self.sampler.select(ctx, state, keys, active=live)
        nxt = torch.where(live, sel.next_nodes, -1)
        stepped = live & (nxt >= 0)
        wstate, stop = state.wstate, torch.zeros_like(stepped)
        if self.workload.has_hooks:
            tctx = transition_ctx(ctx.graph, state.cur, state.prev,
                                  state.step, nxt, deg)
            wstate, stop = apply_hooks(self.workload, ctx.params, tctx,
                                       state.wstate, stepped)
        new_state = WalkerState(
            cur=torch.where(stepped, nxt, state.cur),
            prev=torch.where(stepped, state.cur, state.prev),
            step=state.step + stepped.to(torch.int64),
            # a lane that wanted to step but could not has dead-ended; a
            # lane whose program said stop is equally finished
            alive=state.alive & ~(wants & ~stepped) & ~stop,
            rng=state.rng,
            carry=sel.carry if sel.carry is not None else state.carry,
            wstate=wstate)
        stats = StepStats(live=live.sum(), rjs_served=sel.rjs_served,
                          fallbacks=sel.fallbacks,
                          precomp_served=sel.precomp_served,
                          stale_served=sel.stale_served)
        return new_state, torch.where(stepped, nxt, -1), stats

    def run_epoch_fn(self, state: WalkerState, tables=None, graph=None,
                     stats=None, *, epoch_len: int, num_steps: int,
                     pad: Optional[int] = None):
        """``epoch_len`` steps against explicit table, graph, statistics
        and pad views (default: the engine's own): (state', emitted
        [W, T], the epoch's summed stats as a dict of host ints), by one
        K4 launch on the fused path or the step loop on the staged one."""
        state, emitted, per_step = self.epoch_steps(
            state, tables, graph, stats, epoch_len=epoch_len,
            num_steps=num_steps, pad=pad)
        names = [f.name for f in dataclasses.fields(StepStats)]
        sums = torch.stack([getattr(per_step, n).sum() for n in names])
        return state, emitted, dict(zip(names, sums.cpu().tolist()))

    def epoch_steps(self, state: WalkerState, tables=None, graph=None,
                    stats=None, *, epoch_len: int, num_steps: int,
                    pad: Optional[int] = None):
        """:meth:`run_epoch_fn` with the stats per step: (state', emitted
        [W, T], :class:`StepStats` of [T] counters)."""
        base = self.sampler_ctx
        tables = base.precomp if tables is None else tables
        if self._fused_epoch_fn is not None:
            state, emitted, flags = self._fused_epoch_fn(
                state, epoch_len=epoch_len, num_steps=num_steps,
                bmax=self._fused_bmax, tables=tables)
            return state, emitted, StepStats.from_flag_bits(flags)
        ctx = dataclasses.replace(
            base, precomp=tables, graph=base.graph if graph is None else graph,
            stats=base.stats if stats is None else stats,
            pad=base.pad if pad is None else pad)
        names = [f.name for f in dataclasses.fields(StepStats)]
        emitted, per_step = [], []
        for _ in range(epoch_len):
            state, out, st = self.step(state, num_steps, ctx)
            emitted.append(out.to(torch.int32))
            per_step.append(torch.stack([getattr(st, n).to(torch.int64)
                                         for n in names]))
        per_step = torch.stack(per_step, dim=1)  # [fields, T]
        return state, torch.stack(emitted, dim=1), StepStats(
            *per_step.unbind(0))

    def run(self, starts, num_steps: Optional[int] = None,
            key: Optional[torch.Tensor] = None, batch: Optional[int] = None,
            epoch_len: Optional[int] = None) -> WalkResult:
        """Run all queries through the streaming epoch scheduler (§5.3).

        ``batch`` fixes the slot count (default: all queries at once);
        ``key`` is raw key data ([2] int64, default ``key_data(seed)``).
        Queries are served in start-degree order; results do not depend on
        ``batch`` or ``epoch_len``."""
        num_steps = self.workload.walk_len if num_steps is None else num_steps
        if num_steps <= 0:
            raise ValueError(f"num_steps must be positive, got {num_steps}")
        if batch is not None and batch <= 0:
            raise ValueError(f"batch must be positive, got {batch}")
        if epoch_len is not None and epoch_len <= 0:
            raise ValueError(f"epoch_len must be positive, got {epoch_len}")
        key = key_data(self.config.seed) if key is None else key
        t0 = time.perf_counter()
        starts = np.asarray(starts, np.int64)
        Q = starts.shape[0]
        if Q == 0:
            return WalkResult(paths=np.full((0, num_steps + 1), -1, np.int32),
                              frac_rjs=0.0, rjs_fallbacks=0, steps=num_steps)
        W = int(min(batch or Q, Q))
        T = int(epoch_len or self.config.epoch_len
                or (num_steps if W >= Q
                    else min(num_steps, DEFAULT_EPOCH_LEN)))
        T = max(1, min(T, num_steps))
        sched = EpochScheduler(self, num_steps=num_steps, key=key, slots=W,
                               epoch_len=T, capacity=Q)
        deg_np = self.graph.degrees().cpu().numpy()
        queue = np.argsort(deg_np[starts], kind="stable")  # served in order
        setup = time.perf_counter() - t0
        head = 0
        while head < Q or sched.busy:
            free = sched.free_slots()
            if head < Q and free.size:
                qs = queue[head:head + free.size]
                head += qs.size
                sched.admit(qs, starts[qs])
            sched.run_epoch()
        live = sched.totals["live"]
        return WalkResult(
            paths=sched.paths, frac_rjs=sched.totals["rjs_served"]
            / max(live, 1), rjs_fallbacks=sched.totals["fallbacks"],
            steps=num_steps, live_steps=live,
            frac_precomp=sched.totals["precomp_served"] / max(live, 1),
            frac_stale=sched.totals["stale_served"] / max(live, 1),
            seconds={"setup": setup, **sched.seconds})

    def scheduler(self, num_steps: Optional[int] = None,
                  key: Optional[torch.Tensor] = None, slots: int = 64,
                  epoch_len: Optional[int] = None, capacity: int = 0,
                  track_tables: bool = False) -> EpochScheduler:
        """A long-lived :class:`EpochScheduler` over this engine: what
        ``run`` drives to completion, exposed so a serving loop can admit
        queries at epoch boundaries, read completions per epoch and kill
        lanes, with the same per-query paths as ``run``.  ``key`` is raw
        key data ([2] int64, default ``key_data(seed)``); the epoch length
        defaults to ``config.epoch_len`` or ``min(num_steps, 16)``.
        ``track_tables=True`` re-adopts the engine's tables every epoch
        instead of serving from the view pinned here."""
        num_steps = self.workload.walk_len if num_steps is None else num_steps
        if num_steps <= 0:
            raise ValueError(f"num_steps must be positive, got {num_steps}")
        if slots <= 0:
            raise ValueError(f"slots must be positive, got {slots}")
        key = key_data(self.config.seed) if key is None else key
        T = int(epoch_len or self.config.epoch_len
                or min(num_steps, DEFAULT_EPOCH_LEN))
        T = max(1, min(T, num_steps))
        return EpochScheduler(self, num_steps=num_steps, key=key,
                              slots=int(slots), epoch_len=T,
                              capacity=capacity, track_tables=track_tables)

    def walk_batch(self, starts, key: torch.Tensor, num_steps: int
                   ) -> Tuple[torch.Tensor, StepStats]:
        """One fully occupied batch, no host scheduling: walker i serves
        query i (stream ``fold_in(key, i)``, program state
        ``init_walker_state(i)``, the sampler's initial carry).  Returns
        (paths [W, num_steps] int32 on the engine's device, -1 where a
        walker did not step; :class:`StepStats` of [num_steps]
        counters)."""
        if num_steps <= 0:
            raise ValueError(f"num_steps must be positive, got {num_steps}")
        starts = torch.as_tensor(np.asarray(starts), dtype=torch.int64,
                                 device=self.device)
        W = starts.shape[0]
        state = WalkerState.create(
            starts, key, wstate=self.workload.init_wstate_batch(
                torch.arange(W, dtype=torch.int64, device=self.device)))
        state.carry = self.sampler.init_carry(self.sampler_ctx, W)
        _, emitted, stats = self.epoch_steps(state, epoch_len=num_steps,
                                             num_steps=num_steps)
        return emitted, stats


def exact_probs(graph: CSRGraph, workload: WalkProgram, params, v: int,
                prev: int, step: int, pad: int, wstate=None):
    """Ground-truth transition distribution (p [pad], nbr [pad]) of a
    walker at ``v`` whose previous node is ``prev``; ``wstate`` is that
    ONE walker's program state (leaves without the walker dim)."""
    dev = graph.device
    one = lambda x: torch.tensor([x], dtype=torch.int64, device=dev)
    ctx, mask = tile_ctx(graph, workload, one(v), one(prev), one(step), 0,
                         pad)
    ws = None if wstate is None else tuple(
        torch.as_tensor(leaf, device=dev)[None] for leaf in wstate)
    w = eval_weights(workload, params, ctx, mask, ws)[0].cpu().numpy()
    total = w.sum()
    p = w / total if total > 0 else w
    return p, ctx.nbr[0].cpu().numpy()
