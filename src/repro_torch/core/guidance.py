"""Floorline-guided per-layer training guidance (closing the §VII loop).

The floorline (§VI-A) classifies a *workload*; sparsity-aware training
(§VII-A) needs the verdict per *layer*: which layers should the activation
and weight regularizers push hardest?  This module prices the workload
once, decomposes the step time into per-layer stage times
(:func:`repro_torch.neuromorphic.timestep.layer_stage_times`), places each
layer on a normalized floorline with :meth:`FloorlineModel.classify`, and
turns the per-layer bottleneck states into regularizer weights:

* **traffic-bound** layers get the largest weight — sparsifying their
  messages attacks the term *above* the floorline (§VI-A move (c));
* **memory-bound** layers come next — fewer synops slide them down-left
  along the memory slope (move (a));
* **compute-bound** layers get the smallest weight — activation sparsity
  barely moves an act-latency floor (move (b) wants partitioning).

Within a state, hotter layers (larger stage time) are weighted harder, so
the training signal concentrates on the layers that set the step time.
The stage times are Python floats reduced from the pricer's float64
tensors, so the verdicts and weights are host values.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.analytical import Bottleneck
from repro_torch.core.floorline import FloorlineModel, WorkloadPoint

#: per-state base multipliers (traffic > memory > compute, see module doc)
DEFAULT_STATE_WEIGHTS = {
    Bottleneck.TRAFFIC: 3.0,
    Bottleneck.MEMORY: 2.0,
    Bottleneck.COMPUTE: 1.0,
}


@dataclasses.dataclass(frozen=True)
class LayerGuidance:
    """One layer's floorline placement and the training weight derived
    from it; ``stage`` carries the raw per-layer stage times."""

    name: str
    state: Bottleneck
    weight: float
    stage: object                     # LayerStageTimes


def floorline_layer_guidance(net, xs, profile, part=None, mapping=None, *,
                             cache=None, state_weights=None,
                             traffic_tol: float = 0.25
                             ) -> list[LayerGuidance]:
    """Classify every layer's bottleneck state and derive its regularizer
    weight.  Each layer is placed on a floorline with unit latencies at
    its stage-time coordinates: ``classify`` reads TRAFFIC when the
    layer's NoC share exceeds ``traffic_tol`` of its pipeline bound, else
    MEMORY or COMPUTE by the dominant stage.  Weights are the state's base
    times the layer's relative heat, normalized to mean 1 so a
    regularizer's strength keeps its meaning."""
    from repro_torch.neuromorphic.timestep import layer_stage_times

    stages = layer_stage_times(net, xs, profile, part, mapping, cache=cache)
    state_weights = state_weights or DEFAULT_STATE_WEIGHTS
    model = FloorlineModel(mem_latency=1.0, act_latency=1.0, t0=0.0,
                           traffic_tol=traffic_tol)
    totals = np.array([s.total_time for s in stages], np.float64)
    hot = totals / max(float(totals.max()), 1e-30)
    placed, raw = [], []
    for s, h in zip(stages, hot):
        state = model.classify(WorkloadPoint(
            max_synops=s.mem_time, max_acts=s.act_time, time=s.total_time,
            label=s.name))
        raw.append(state_weights[state] * float(h))
        placed.append((s, state))
    mean = max(float(np.mean(raw)), 1e-30)
    return [LayerGuidance(name=s.name, state=state, weight=w / mean, stage=s)
            for (s, state), w in zip(placed, raw)]


def floorline_layer_weights(net, xs, profile, part=None, mapping=None, *,
                            cache=None, state_weights=None,
                            traffic_tol: float = 0.25) -> np.ndarray:
    """Just the per-layer weight vector (mean 1.0), float64."""
    gs = floorline_layer_guidance(net, xs, profile, part, mapping,
                                  cache=cache, state_weights=state_weights,
                                  traffic_tol=traffic_tol)
    return np.array([g.weight for g in gs], np.float64)
