"""Partitioning: logical neuron->neurocore assignment (paper §II-A, §III-C/D).

A :class:`Partition` assigns each layer a number of neurocores; neurons are
split into contiguous equal ranges (output-channel ranges for conv layers, so
every core holds complete channels and — as on the real chips — every input
message must be delivered to every core of the layer).

``minimal_partition`` computes the 'involuntary' utilization forced by the
chip's per-core neuron-state and synaptic-memory limits (§III-D); splits on
top of that are the 'voluntary' partitioning of §III-C.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.neuromorphic.network import SimNetwork
from repro_torch.neuromorphic.platform import ChipProfile


@dataclasses.dataclass(frozen=True)
class Partition:
    """Per-layer neurocore counts."""

    cores: tuple[int, ...]

    @property
    def total_cores(self) -> int:
        return int(sum(self.cores))

    def ranges(self, layer_idx: int, n_neurons: int) -> list[tuple[int, int]]:
        """Contiguous [start, end) neuron ranges for the layer's cores."""
        c = self.cores[layer_idx]
        bounds = np.linspace(0, n_neurons, c + 1).astype(int)
        return [(int(bounds[i]), int(bounds[i + 1])) for i in range(c)]

    def boundaries(self, layer_idx: int, n_neurons: int) -> np.ndarray:
        c = self.cores[layer_idx]
        return np.linspace(0, n_neurons, c + 1).astype(int)

    def split(self, layer_idx: int, by: int = 1) -> "Partition":
        """Grow a layer by ``by`` cores — the §VI-B memory/compute move."""
        cores = list(self.cores)
        cores[layer_idx] += by
        return Partition(tuple(cores))

    def merge(self, layer_idx: int, by: int = 1) -> "Partition":
        """Shrink a layer by ``by`` cores (coagulation, §VI-A move (c)):
        fewer cores per layer lowers NoC duplication and active power.  The
        inverse of :meth:`split`; callers must re-validate the result."""
        cores = list(self.cores)
        cores[layer_idx] = max(1, cores[layer_idx] - by)
        return Partition(tuple(cores))

    def with_layer(self, layer_idx: int, n_cores: int) -> "Partition":
        cores = list(self.cores)
        cores[layer_idx] = n_cores
        return Partition(tuple(cores))

    def core_layer_ids(self) -> np.ndarray:
        """layer index of each logical core, in global logical order."""
        return np.concatenate([np.full(c, i, np.int32)
                               for i, c in enumerate(self.cores)])


def max_cores_for_layer(net: SimNetwork, layer_idx: int) -> int:
    """Partitioning granularity limit: fc splits by neuron, conv by channel."""
    layer = net.layers[layer_idx]
    if layer.kind == "conv":
        return int(layer.weights.shape[3])
    return layer.n_neurons


def layer_fits(layer, n_cores: int, profile: ChipProfile) -> bool:
    """Per-core capacity predicate: ``n_cores`` cores satisfy the chip's
    neuron-state and synaptic-memory limits for this layer.  The single
    source of the capacity formulas — ``minimal_partition`` and
    ``validate_partition`` both go through here."""
    return (-(-layer.n_neurons // n_cores) <= profile.neurons_per_core
            and layer.weights_per_core(n_cores) <= profile.synapses_per_core)


def _min_cores(net: SimNetwork, layer_idx: int, profile: ChipProfile) -> int:
    layer = net.layers[layer_idx]
    cap = max_cores_for_layer(net, layer_idx)
    for c in range(1, cap + 1):
        if layer_fits(layer, c, profile):
            return c
    raise ValueError(
        f"layer {layer.name} cannot fit on {profile.name} at any split")


def minimal_partition(net: SimNetwork, profile: ChipProfile) -> Partition:
    """Involuntary utilization (§III-D): fewest cores per layer that satisfy
    the chip's neuron and synaptic memory capacities."""
    if not profile.allow_partitioning:
        # e.g. Speck: exactly one core per layer; capacities must hold.
        for i, l in enumerate(net.layers):
            if (l.n_neurons > profile.neurons_per_core
                    or l.n_weights > profile.synapses_per_core):
                raise ValueError(
                    f"layer {l.name} exceeds {profile.name} per-core capacity "
                    "and the platform does not support partitioning")
        return Partition(tuple(1 for _ in net.layers))
    cores = tuple(_min_cores(net, i, profile) for i in range(len(net.layers)))
    part = Partition(cores)
    if part.total_cores > profile.n_cores:
        raise ValueError(
            f"network needs {part.total_cores} cores minimum; "
            f"{profile.name} has {profile.n_cores}")
    return part


def validate_partition(net: SimNetwork, part: Partition,
                       profile: ChipProfile) -> bool:
    """True iff the partition respects chip capacities and core budget."""
    if len(part.cores) != len(net.layers):
        return False
    if part.total_cores > profile.n_cores:
        return False
    if not profile.allow_partitioning and any(c != 1 for c in part.cores):
        return False
    for i, layer in enumerate(net.layers):
        c = part.cores[i]
        if c < 1 or c > max_cores_for_layer(net, i):
            return False
        if not layer_fits(layer, c, profile):
            return False
    return True
