"""Neurocore-aware workload metrics (paper insight M0).

The paper's central measurement finding: *network-wide* sparsity / op totals
are unreliable performance predictors on barrier-synchronized parallel
hardware — the **maximum per-unit** load governs the step time.  This module
computes both views from per-unit counters so the gap itself is reportable.
Inputs are small host arrays (one value per core or link).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LoadStats:
    """Aggregate vs per-unit view of one counter (M0)."""

    total: float
    max: float
    mean: float
    imbalance: float        # max / mean over *active* units; 1.0 = balanced
    n_units: int
    n_active: int

    @staticmethod
    def of(per_unit: np.ndarray) -> "LoadStats":
        per_unit = np.asarray(per_unit, dtype=np.float64).ravel()
        active = per_unit > 0
        n_active = int(np.sum(active))
        total = float(np.sum(per_unit))
        mx = float(np.max(per_unit)) if per_unit.size else 0.0
        mean = total / max(n_active, 1)
        return LoadStats(total=total, max=mx, mean=mean,
                         imbalance=(mx / mean) if mean > 0 else 1.0,
                         n_units=int(per_unit.size), n_active=n_active)


@dataclasses.dataclass(frozen=True)
class WorkloadMetrics:
    """Full M0 metric set for one workload configuration / step."""

    synops: LoadStats          # per-neurocore synop accumulations
    acts: LoadStats            # per-neurocore activation computes
    traffic: LoadStats         # per-NoC-link message loads
    msgs_total: float          # total activation messages emitted
    weight_density: float      # network-wide (the "conventional proxy")
    act_density: float         # network-wide (the "conventional proxy")

    @property
    def max_synops(self) -> float:
        return self.synops.max

    @property
    def max_acts(self) -> float:
        return self.acts.max

    @property
    def max_link_load(self) -> float:
        return self.traffic.max


def network_wide_density(nnz: float, capacity: float) -> float:
    """The conventional aggregate proxy the paper shows to be insufficient."""
    return float(nnz) / max(float(capacity), 1.0)


def proxy_gap(metrics: WorkloadMetrics) -> float:
    """How much the aggregate proxy under-states the true bottleneck:
    max-per-core synops vs what a perfectly balanced network would give.
    1.0 = aggregate proxy is exact; >1 = load imbalance invalidates it."""
    return metrics.synops.imbalance
