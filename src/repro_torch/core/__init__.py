"""FlexiWalker core of the port: the engine, the sampler registry and the
regimes of the adaptive main path."""
from repro_torch.core.cost_model import CostModel
from repro_torch.core.flexi_compiler import (FALLBACK, PER_KERNEL, PER_STEP,
                                             BoundInputs, CompiledWorkload,
                                             analyze, is_static)
from repro_torch.core.precomp import PrecompTables, build_tables
from repro_torch.core.runtime import (EngineConfig, EpochReport,
                                      EpochScheduler, WalkEngine, WalkResult,
                                      exact_probs)
from repro_torch.core.samplers import (PRECOMP_EXEC_CHOICES,
                                       InterleavedSampler, PartitionedSampler,
                                       PrefetchTile, Sampler, SamplerCaps,
                                       SamplerContext, Selection,
                                       available_samplers, get_sampler,
                                       register_sampler)
from repro_torch.core.types import EdgeCtx, StepStats, WalkerState, WalkProgram

__all__ = ["CostModel", "FALLBACK", "PER_KERNEL", "PER_STEP", "BoundInputs",
           "CompiledWorkload", "analyze", "is_static", "PrecompTables",
           "build_tables", "EngineConfig", "EpochReport", "EpochScheduler",
           "WalkEngine", "WalkResult", "exact_probs", "PRECOMP_EXEC_CHOICES",
           "InterleavedSampler", "PartitionedSampler", "PrefetchTile",
           "Sampler", "SamplerCaps", "SamplerContext", "Selection",
           "available_samplers", "get_sampler", "register_sampler",
           "EdgeCtx", "StepStats", "WalkerState", "WalkProgram"]
