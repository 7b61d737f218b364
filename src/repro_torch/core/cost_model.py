"""Flexi-Runtime's first-order cost model (port of
``repro/core/cost_model.py``; paper §4.1, Eqs. 9–11).

Eq. 11: prefer eRJS over eRVS iff ratio · max-bound < Σ-estimate.  The
precomputed regime wins where log₂(d) table probes beat the O(d) pass.
``DEFAULT_EDGE_COST_RATIO`` stays the reference's 4.0 in this slice so the
port's regime decisions match the reference's; re-profiling it on the
H100 is queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import torch

DEFAULT_EDGE_COST_RATIO = 4.0


@dataclasses.dataclass(frozen=True)
class CostModel:
    """edge_cost_ratio = EdgeCost_RJS / EdgeCost_RVS."""

    edge_cost_ratio: float = DEFAULT_EDGE_COST_RATIO
    min_rjs_degree: int = 8
    lookup_cost_ratio: float = 1.0
    min_precomp_degree: int = 4
    stale_penalty: float = 1.25

    def prefer_rjs(self, bound_max: torch.Tensor, sum_est: torch.Tensor,
                   degree: torch.Tensor) -> torch.Tensor:
        """Vectorised Eq. 11 decision per walker."""
        ok = self.edge_cost_ratio * bound_max < sum_est
        return ok & (degree >= self.min_rjs_degree) & (bound_max > 0)

    def prefer_precomp(self, degree: torch.Tensor,
                       frac_stale=0.0) -> torch.Tensor:
        """Table regime's cost side: log₂(d+1) probes (discounted by the
        stale fraction) against the d-edge streaming pass."""
        d = degree.clamp_min(1).to(torch.float32)
        cost_pre = self.lookup_cost_ratio * torch.log2(d + 1.0)
        exp_cost = ((1.0 - frac_stale) * cost_pre
                    + frac_stale * self.stale_penalty * d)
        return (exp_cost < d) & (degree >= self.min_precomp_degree)
