"""Analytical bound-and-bottleneck model (paper Section III).

Closed-form operation counts for one fully-connected layer ``l_i`` of a
feed-forward network mapped onto a neuromorphic chip:

* ``N``  — neurons per layer (previous / current / next layers share N),
* ``w``  — weight density  (weight sparsity = 1 - w),
* ``m``  — message (activation) density of l_{i-1} and l_i,
* ``C``  — neurocores assigned to a layer ('voluntary' partitioning),
* ``x``  — width scale factor forcing 'involuntary' utilization (§III-D).

The three core operations (per §III):
  (a) synops            — weight fetch + multiply-accumulate, per neurocore,
  (b) activation computes — neuron updates, per neurocore,
  (c) message traffic   — NoC activation messages to the next layer (total).

All counts are *expected* values under uniform random sparsity, matching the
paper's asymptotic treatment.  These are used to (1) predict bottleneck states
before running the simulator and (2) property-test the simulator's measured
counters against theory.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class Bottleneck(enum.Enum):
    """The three bottleneck states established by the paper (§III-E, M1-M3)."""

    MEMORY = "memory"      # M1: synop weight fetch / writeback dominates
    COMPUTE = "compute"    # M2: neuron activation computation dominates
    TRAFFIC = "traffic"    # M3: NoC message traffic dominates


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """Workload configuration knobs for one layer (paper §III-A)."""

    n_neurons: int             # N
    weight_density: float      # w in [0, 1]
    msg_density: float         # m in [0, 1] (activation density of l_{i-1} and l_i)
    cores: int = 1             # C_i  ('voluntary' partitioning)
    cores_next: int = 1        # C_{i+1}
    width_scale: float = 1.0   # x   ('involuntary' utilization, §III-D)

    def __post_init__(self) -> None:
        if not (0.0 <= self.weight_density <= 1.0):
            raise ValueError(f"weight_density must be in [0,1], got {self.weight_density}")
        if not (0.0 <= self.msg_density <= 1.0):
            raise ValueError(f"msg_density must be in [0,1], got {self.msg_density}")
        if self.cores < 1 or self.cores_next < 1:
            raise ValueError("core counts must be >= 1")
        if self.width_scale < 1.0:
            raise ValueError("width_scale (x) must be >= 1")


@dataclasses.dataclass(frozen=True)
class OpCounts:
    """Expected per-timestep operation counts for one layer."""

    synops_per_core: float
    act_computes_per_core: float
    traffic_total: float
    inputs_per_core: float      # messages arriving at each core of l_i
    cores_used: int

    def dominant(self, costs: "OpCosts") -> Bottleneck:
        """Which operation dominates the (pipelined) per-step cost."""
        t_mem = costs.c_synop * self.synops_per_core
        t_act = costs.c_act * self.act_computes_per_core
        t_msg = costs.c_msg * self.traffic_total
        best = max((t_mem, Bottleneck.MEMORY), (t_act, Bottleneck.COMPUTE),
                   (t_msg, Bottleneck.TRAFFIC), key=lambda p: p[0])
        return best[1]


@dataclasses.dataclass(frozen=True)
class OpCosts:
    """Relative unit costs; per the paper (§II-A, [12],[52]) the three are
    within one order of magnitude on real neuromorphic silicon."""

    c_synop: float = 1.0
    c_act: float = 2.0
    c_msg: float = 1.0


def expected_inputs(n_neurons: int, msg_density: float) -> float:
    """E[# input messages to l_i] = m * N  (§III-B)."""
    return msg_density * n_neurons


def p_neuron_messaged(n_inputs: float, weight_density: float) -> float:
    """P[a neuron receives >= 1 synop] = 1 - (1-w)^{mN}  (paper eq. 3)."""
    if weight_density >= 1.0:
        return 1.0 if n_inputs > 0 else 0.0
    if n_inputs <= 0:
        return 0.0
    # Compute in log space for numerical robustness with large mN.
    log_miss = n_inputs * math.log1p(-weight_density)
    return -math.expm1(log_miss)


def layer_op_counts(cfg: LayerConfig, *, idealized_acts: bool = False) -> OpCounts:
    """Expected per-timestep op counts for layer l_i under configuration cfg.

    Covers all three regimes of §III:
      * single core      (cfg.cores == 1, width_scale == 1)   -> §III-B
      * voluntary cores  (cfg.cores > 1)                       -> §III-C
      * forced width     (cfg.width_scale > 1)                 -> §III-D
        (voluntary partitioning may stack on top of forced utilization)

    With ``idealized_acts`` the activation-compute count uses the idealized
    assumption that a neuron only computes if it received >= 1 synop
    (paper eq. 3); otherwise every mapped neuron updates (~O(N/C), the
    behaviour the paper observes on synchronous hardware).
    """
    x = cfg.width_scale
    n = cfg.n_neurons * x                       # actual layer width
    inputs_total = cfg.msg_density * n          # mxN messages from l_{i-1}

    # §III-D: width scaling forces C = O(x^2) cores minimum; voluntary
    # partitioning multiplies on top.
    forced_cores = max(1, math.ceil(x * x))
    cores = int(cfg.cores * forced_cores)
    cores_next = int(cfg.cores_next * forced_cores)
    neurons_per_core = n / cores

    # (a) synops per core: each input fetches the w-dense weights of the
    # neurons mapped to that core.
    synops_core = inputs_total * cfg.weight_density * neurons_per_core

    # (b) activation computes per core.
    if idealized_acts:
        acts_core = neurons_per_core * p_neuron_messaged(inputs_total, cfg.weight_density)
    else:
        acts_core = neurons_per_core

    # (c) traffic: every one of the m*n output messages is duplicated to each
    # core of l_{i+1} (broadcast; §III-C).
    traffic = cfg.msg_density * n * cores_next

    return OpCounts(
        synops_per_core=synops_core,
        act_computes_per_core=acts_core,
        traffic_total=traffic,
        inputs_per_core=inputs_total,
        cores_used=cores,
    )


def predict_bottleneck(cfg: LayerConfig, costs: OpCosts | None = None) -> Bottleneck:
    """Predict the bottleneck state for a layer configuration (M1-M3)."""
    return layer_op_counts(cfg).dominant(costs or OpCosts())


def min_cores_for_layer(n_neurons: int, fanin: int, *, neurons_per_core: int,
                        synapses_per_core: int) -> int:
    """Minimum ('involuntary') neurocore count for a layer given chip limits
    (§III-D): the layer must fit both neuron-state and synaptic memory."""
    by_neurons = math.ceil(n_neurons / neurons_per_core)
    by_synapses = math.ceil((n_neurons * fanin) / synapses_per_core)
    return max(1, by_neurons, by_synapses)


def sweep_width_scaling(base: LayerConfig, scales: list[float]) -> list[OpCounts]:
    """§III-D sweep: op counts as width scales.  Used by tests to check the
    paper's claims: synops/core ~ constant, traffic ~ O(m x^3 N)."""
    return [layer_op_counts(dataclasses.replace(base, width_scale=float(s))) for s in scales]
