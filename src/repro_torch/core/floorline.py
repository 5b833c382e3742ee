"""The floorline performance model (paper §VI-A, Fig. 9).

A visual/analytical model relating a workload's **intensity** — the maximum
synops executed by any active neurocore in a timestep — to its **performance**
— the timestep duration:

            time
              ^        /  <- memory bound: slope = per-synop memory latency
              |   x   /
              | x    /          x = traffic-bound workloads (above the line)
              |     /
              |____/______      <- compute floor: c_act * max activation
              |                    computes of any core (variable height)
              +------------------> max per-core synops ("intensity")

A workload's position relative to the floorline fully determines its
bottleneck state and the optimization move (§VI-A a/b/c):

  (a) on the slope  -> memory-bound  -> raise sparsity or partition the
                                        synop-bottleneck layer (down-left),
  (b) on the floor  -> compute-bound -> partition the act-compute-bottleneck
                                        layer (straight down),
  (c) above the line-> traffic-bound -> raise activation sparsity, coagulate
                                        cores, or improve the mapping (down).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.analytical import Bottleneck


@dataclasses.dataclass(frozen=True)
class WorkloadPoint:
    """One measured workload configuration, placed on the floorline.

    ``max_synops``/``max_acts`` are per-timestep maxima over active neurocores
    (the M0 neurocore-aware metrics); ``time`` is measured timestep duration;
    ``energy`` is optional measured energy/step.
    """

    max_synops: float
    max_acts: float
    time: float
    energy: float = float("nan")
    label: str = ""


@dataclasses.dataclass(frozen=True)
class OptimizationMove:
    """An actionable optimization recommendation (§VI-A bottom)."""

    state: Bottleneck
    action: str
    direction: str   # movement on the floorline plot


_MOVES = {
    Bottleneck.MEMORY: OptimizationMove(
        Bottleneck.MEMORY,
        action=("reduce max per-core synops: increase weight/activation "
                "sparsity or partition the synop-bottleneck layer"),
        direction="down-left along the memory slope",
    ),
    Bottleneck.COMPUTE: OptimizationMove(
        Bottleneck.COMPUTE,
        action=("reduce max per-core activation computes: partition the "
                "compute-bottleneck layer"),
        direction="straight down (lowers the floor)",
    ),
    Bottleneck.TRAFFIC: OptimizationMove(
        Bottleneck.TRAFFIC,
        action=("reduce NoC traffic: increase activation sparsity, coagulate "
                "into fewer cores, or improve the neurocore mapping"),
        direction="down toward the floorline",
    ),
}


@dataclasses.dataclass
class FloorlineModel:
    """Fitted floorline: time = max(mem_latency*S_max, act_latency*A_max) + t0.

    ``mem_latency``  — seconds per synop on the bottleneck core (the slope),
    ``act_latency``  — seconds per activation compute (sets the floor height
                       together with the workload's max per-core acts),
    ``t0``           — fixed per-timestep overhead (barrier sync etc.),
    ``traffic_tol``  — relative excess over the predicted bound beyond which a
                       point is classified traffic-bound (above the line).
    """

    mem_latency: float
    act_latency: float
    t0: float = 0.0
    traffic_tol: float = 0.25

    # ---------------------------------------------------------------- bounds
    def memory_bound(self, max_synops: float) -> float:
        return self.mem_latency * max_synops + self.t0

    def compute_floor(self, max_acts: float) -> float:
        return self.act_latency * max_acts + self.t0

    def predicted_time(self, max_synops: float, max_acts: float) -> float:
        """The floorline bound: pipelined stages overlap, so the slowest
        stage of the slowest core sets the timestep (§VI-A assumptions)."""
        return max(self.mem_latency * max_synops,
                   self.act_latency * max_acts) + self.t0

    # ---------------------------------------------------------- classification
    def classify(self, point: WorkloadPoint) -> Bottleneck:
        """Place a workload on the floorline -> bottleneck state (a)/(b)/(c)."""
        bound = self.predicted_time(point.max_synops, point.max_acts)
        if point.time > bound * (1.0 + self.traffic_tol):
            return Bottleneck.TRAFFIC
        mem_term = self.mem_latency * point.max_synops
        act_term = self.act_latency * point.max_acts
        return Bottleneck.MEMORY if mem_term >= act_term else Bottleneck.COMPUTE

    def recommend(self, point: WorkloadPoint) -> OptimizationMove:
        return _MOVES[self.classify(point)]

    def efficiency(self, point: WorkloadPoint) -> float:
        """Fraction of the floorline bound achieved (<=1 on/below the line)."""
        return self.predicted_time(point.max_synops, point.max_acts) / max(point.time, 1e-30)


def fit_floorline(points: Sequence[WorkloadPoint], *, n_iters: int = 50,
                  traffic_tol: float = 0.25) -> FloorlineModel:
    """Fit (mem_latency, act_latency, t0) from profiled workload points by
    alternating assignment: assign each point to its dominant term, then
    least-squares each term on its assigned points.  Traffic-bound outliers
    (far above the current bound) are excluded from the fit, mirroring how
    the paper draws boundaries from the lower envelope of measurements.
    """
    if not points:
        raise ValueError("need at least one point to fit a floorline")
    s = np.asarray([p.max_synops for p in points], dtype=np.float64)
    a = np.asarray([p.max_acts for p in points], dtype=np.float64)
    t = np.asarray([p.time for p in points], dtype=np.float64)

    # Initial guesses from extreme points.
    t0 = float(np.min(t)) * 0.1
    hi = int(np.argmax(s))
    mem = max((t[hi] - t0) / max(s[hi], 1e-30), 1e-30)
    lo = int(np.argmin(s))
    act = max((t[lo] - t0) / max(a[lo], 1e-30), 1e-30)

    for _ in range(n_iters):
        mem_term = mem * s
        act_term = act * a
        bound = np.maximum(mem_term, act_term) + t0
        keep = t <= bound * (1.0 + traffic_tol)          # drop traffic outliers
        if not np.any(keep):
            keep = np.ones_like(t, dtype=bool)
        mem_pts = keep & (mem_term >= act_term)
        act_pts = keep & ~mem_pts
        new_mem, new_act = mem, act
        if np.any(mem_pts) and np.sum(s[mem_pts] ** 2) > 0:
            new_mem = float(np.sum((t[mem_pts] - t0) * s[mem_pts])
                            / np.sum(s[mem_pts] ** 2))
        if np.any(act_pts) and np.sum(a[act_pts] ** 2) > 0:
            new_act = float(np.sum((t[act_pts] - t0) * a[act_pts])
                            / np.sum(a[act_pts] ** 2))
        new_mem = max(new_mem, 1e-30)
        new_act = max(new_act, 1e-30)
        if math.isclose(new_mem, mem, rel_tol=1e-9) and math.isclose(new_act, act, rel_tol=1e-9):
            mem, act = new_mem, new_act
            break
        mem, act = new_mem, new_act

    return FloorlineModel(mem_latency=mem, act_latency=act, t0=t0,
                          traffic_tol=traffic_tol)


def floorline_curve(model: FloorlineModel, max_acts: float,
                    synops_range: tuple[float, float], n: int = 64,
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Sample the floorline boundary for plotting/reporting: the memory slope
    clipped below by the compute floor for a given max-acts workload."""
    xs = np.geomspace(max(synops_range[0], 1.0), max(synops_range[1], 2.0), n)
    ys = np.maximum(model.mem_latency * xs, model.act_latency * max_acts) + model.t0
    return xs, ys
