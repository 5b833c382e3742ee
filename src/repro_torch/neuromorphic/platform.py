"""Neuromorphic chip profiles (paper §IV).

Cost constants are *relative units* calibrated so that synop memory access,
activation compute, and NoC hop costs sit within one order of magnitude of
each other, per the circuit-level analyses the paper builds on ([12], [52]).
The paper reports normalized performance; we do the same — trends, crossovers
and ratios are the validation target, not absolute seconds/joules.
"""

from __future__ import annotations

import dataclasses


# Per-neuron-update instruction-cost multipliers (relative to plain ReLU).
# SD-ReLU keeps sigma-delta state (reconstruct + threshold + quantize);
# SSM neurons update recurrent state (complex diag A -> 2 real MACs + IO).
NEURON_COST = {
    "relu": 1.0,
    "if": 1.2,        # integrate-and-fire: accumulate, compare, reset
    "sd_relu": 2.5,   # sigma-delta ReLU [34]
    "ssm": 6.0,       # S5-style state update [38], [47]
}


@dataclasses.dataclass(frozen=True)
class ChipProfile:
    """One neuromorphic accelerator's architecture + cost model."""

    name: str
    n_cores: int
    grid: tuple[int, int]               # NoC *router* grid (rows, cols); several
                                        # cores share each router tile
    neurons_per_core: int               # neuron-state memory limit
    synapses_per_core: int              # synaptic weight memory limit (words)
    synchronous: bool = True            # barrier-synchronized timesteps
    allow_partitioning: bool = True     # Speck: one layer per core, no splits

    # --- timing costs (relative time units) -------------------------------
    c_fetch: float = 1.0        # fetch one synaptic weight word
    c_mac: float = 0.25         # multiply-accumulate one fetched weight
    c_decode_word: float = 0.25 # sparse-format per-word decode overhead
    c_decode_msg: float = 8.0   # sparse-format fixed per-message decode setup
    c_msg_recv: float = 2.0     # receive/enqueue one input message
    c_act: float = 4.0          # one neuron update (x NEURON_COST multiplier)
    c_msg_hop: float = 1.5      # one message crossing one NoC link
    c_route: float = 1.0        # router service time per packet touching it
    c_inject: float = 0.5       # per-packet injection serialization at a core
    t_barrier: float = 100.0    # barrier sync + timestep bookkeeping
    t_core_fixed: float = 20.0  # per-active-core fixed timestep overhead

    # --- energy costs (relative energy units) -----------------------------
    e_fetch: float = 1.0
    e_mac: float = 0.8          # skipped for zero weights (dense format)
    e_decode: float = 0.2
    e_act: float = 2.0
    e_msg_hop: float = 1.2
    p_idle: float = 0.05        # static power (energy per time unit)
    p_core: float = 0.02        # per-active-core power (energy per time unit)

    # Default weight format per layer kind; Fig. 4: Loihi 2 defaults to dense
    # for CNNs and sparse for linearly-connected layers.
    default_format_fc: str = "sparse"
    default_format_conv: str = "dense"

    def neuron_cost(self, neuron_model: str) -> float:
        return self.c_act * NEURON_COST[neuron_model]


def loihi2_like(**overrides) -> ChipProfile:
    """Research-class chip: 120 programmable cores, arbitrary partitioning,
    selectable weight formats (paper §IV-3)."""
    return ChipProfile(
        name="loihi2_like", n_cores=120, grid=(5, 6),   # 30 routers x 4 cores
        neurons_per_core=8192, synapses_per_core=64 * 1024,
        synchronous=True, allow_partitioning=True,
        **overrides,
    )


def akd1000_like(**overrides) -> ChipProfile:
    """Edge CNN accelerator: 80 cores, dense CNN weight formatting only
    (paper §IV-1 — explains the Fig. 2 weight-sparsity non-result)."""
    return ChipProfile(
        name="akd1000_like", n_cores=80, grid=(4, 5),   # 20 routers x 4 cores
        neurons_per_core=8192, synapses_per_core=128 * 1024,
        synchronous=True, allow_partitioning=True,
        default_format_fc="dense", default_format_conv="dense",
        **overrides,
    )


def speck_like(**overrides) -> ChipProfile:
    """Micro-edge event-camera chip: 9 cores, fully asynchronous, one layer
    per core, IF neurons (paper §IV-2).  Async => no barrier; cores idle when
    no events are present, and sample latency is the pipeline sum."""
    return ChipProfile(
        name="speck_like", n_cores=9, grid=(3, 3),
        neurons_per_core=128 * 1024, synapses_per_core=256 * 1024,
        synchronous=False, allow_partitioning=False,
        default_format_fc="dense", default_format_conv="dense",
        t_barrier=0.0, p_idle=0.002,   # near-zero static draw when idle
        **overrides,
    )


PROFILES = {
    "loihi2": loihi2_like,
    "akd1000": akd1000_like,
    "speck": speck_like,
}
