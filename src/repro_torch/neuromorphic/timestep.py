"""Barrier-synchronized timestep cost model + simulation entry point.

Within a timestep every neurocore (1) accumulates synops for each input
message, (2) computes activations, (3) emits activation messages, (4)
barrier-syncs.  A core's time is the max of its memory and compute stages;
the timestep is set by the slowest core or by NoC congestion, plus barrier
overhead.  Asynchronous platforms (Speck) have no barrier: a sample's
latency is the pipeline sum over layers.

Two engines price a workload:

* ``engine="batched"`` (default) — layer-major: the functional network runs
  once per layer over the whole ``(T, n)`` block (:meth:`SimNetwork.
  run_batch`), counters reduce to per-layer neuron-axis cumulative sums
  (:func:`precompute_pricing`), and one (partition, mapping) candidate is
  priced from them with (T, cores) tensor ops (:func:`price_candidate`).
* ``engine="reference"`` — the step-major loop, kept for exact parity.

All per-step and per-neuron pricing arrays are float64 tensors on the
network's device; integer counts stay exact in float64, so the priced
report matches the JAX package's NumPy pricing to float64 roundoff.

:func:`simulate_population` prices many (partition, mapping) candidates
from one functional run: per candidate through :func:`price_candidate`
(``backend="numpy"``), or all at once in one batched float64 program on
the device whose input is the stacked genome rows (``backend="device"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.metrics import LoadStats, WorkloadMetrics
from repro_torch.neuromorphic.network import CounterMaps, SimNetwork
from repro_torch.neuromorphic.noc import (Mapping, cores_per_router,
                                          flow_structures_rows,
                                          incidence_tables, ordered_mapping,
                                          route_batch, route_step)
from repro_torch.neuromorphic.partition import (Partition,
                                                max_cores_for_layer,
                                                minimal_partition)
from repro_torch.neuromorphic.platform import ChipProfile

#: Engine used when :func:`simulate` is called without ``engine=``.
DEFAULT_ENGINE = "batched"

_F64 = torch.float64


@dataclasses.dataclass
class CoreCounters:
    """Per-core event counts for one layer at one timestep (float64)."""

    msgs_in: torch.Tensor      # input messages seen by each core (broadcast)
    synops: torch.Tensor       # format-effective weight fetches per core
    macs: torch.Tensor         # nnz multiply-accumulates per core
    acts: torch.Tensor         # neuron updates per core
    msgs_out: torch.Tensor     # messages emitted per core
    neurons: torch.Tensor      # neurons mapped per core
    sparse_format: bool


@dataclasses.dataclass
class BatchCoreCounters:
    """Per-core event counts for one layer over ALL timesteps: every tensor
    is (T, cores) float64 except ``neurons`` (cores,)."""

    msgs_in: torch.Tensor
    synops: torch.Tensor
    macs: torch.Tensor
    acts: torch.Tensor
    msgs_out: torch.Tensor
    neurons: torch.Tensor
    sparse_format: bool


def _bounds(part: Partition, layer_idx: int, n: int,
            device: torch.device) -> torch.Tensor:
    """Core boundaries (numpy ``linspace`` integers, exactly the
    reference's) as an index tensor."""
    return torch.as_tensor(part.boundaries(layer_idx, n), dtype=torch.int64,
                           device=device)


def _segment_sums(per_neuron: torch.Tensor,
                  bounds: torch.Tensor) -> torch.Tensor:
    csum = torch.cat([torch.zeros(1, dtype=_F64, device=per_neuron.device),
                      torch.cumsum(per_neuron.to(_F64), dim=0)])
    return csum[bounds[1:]] - csum[bounds[:-1]]


def _layer_format(layer, profile: ChipProfile) -> bool:
    fmt = layer.weight_format or (
        profile.default_format_conv if layer.kind == "conv"
        else profile.default_format_fc)
    return fmt == "sparse"


def aggregate_layer(counters: CounterMaps, layer_idx: int, part: Partition,
                    net: SimNetwork, profile: ChipProfile) -> CoreCounters:
    layer = net.layers[layer_idx]
    dev = counters.macs.device
    bounds = _bounds(part, layer_idx, layer.n_neurons, dev)
    sparse = _layer_format(layer, profile)
    macs = _segment_sums(counters.macs, bounds)
    fetches_dense = _segment_sums(counters.fetches_dense, bounds)
    acts_map = (counters.acts_evented if not profile.synchronous
                else torch.ones_like(counters.macs))
    return CoreCounters(
        msgs_in=counters.msgs_in.to(_F64).expand(part.cores[layer_idx]),
        synops=macs if sparse else fetches_dense,
        macs=macs,
        acts=_segment_sums(acts_map, bounds),
        msgs_out=_segment_sums(counters.msgs_out, bounds),
        neurons=torch.diff(bounds).to(_F64),
        sparse_format=sparse,
    )


def core_times(cc, neuron_model: str, profile: ChipProfile):
    """(memory-stage, compute-stage) time per core of one layer, for both
    :class:`CoreCounters` and :class:`BatchCoreCounters`."""
    p = profile
    if cc.sparse_format:
        mem = (cc.msgs_in * (p.c_msg_recv + p.c_decode_msg)
               + cc.synops * (p.c_fetch + p.c_decode_word + p.c_mac))
    else:
        mem = cc.msgs_in * p.c_msg_recv + cc.synops * (p.c_fetch + p.c_mac)
    act = cc.acts * p.neuron_cost(neuron_model)
    return mem, act


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().to("cpu").numpy()


@dataclasses.dataclass
class SimReport:
    """Simulation output: performance + M0 metrics + raw per-core arrays.

    ``times``/``energies`` (per step), ``outputs`` (T, out) and the
    ``per_core_*`` means (partition order) are tensors on the network's
    device; the scalars are Python floats.  ``bottleneck_stage`` names the
    term that set the step time on a plurality of steps.
    """

    time_per_step: float
    energy_per_step: float
    times: torch.Tensor
    energies: torch.Tensor
    metrics: WorkloadMetrics
    max_synops: float
    max_acts: float
    max_link_load: float
    n_cores_active: int
    outputs: torch.Tensor
    per_core_synops: torch.Tensor
    per_core_acts: torch.Tensor
    per_core_msgs_out: torch.Tensor
    bottleneck_stage: str

    def summary(self) -> str:
        return (f"time/step={self.time_per_step:.1f} "
                f"energy/step={self.energy_per_step:.1f} "
                f"max_synops={self.max_synops:.0f} "
                f"cores={self.n_cores_active} "
                f"bottleneck={self.bottleneck_stage}")


def apply_profile(net: SimNetwork, sparsity_profile, **bound) -> SimNetwork:
    """``net`` under a trained sparsity profile (``net`` itself without
    one).  ``bound`` holds the caller's cache / cached run arguments: a
    given one is bound to the un-profiled network, so combining it with a
    profile raises ``ValueError``."""
    if sparsity_profile is None:
        return net
    given = [k for k, v in bound.items() if v is not None]
    if given:
        raise ValueError(f"sparsity_profile cannot be combined with "
                         f"{'/'.join(given)}: bound to the un-profiled "
                         "network")
    return sparsity_profile.apply(net)


def simulate(net: SimNetwork, xs, profile: ChipProfile,
             part: Partition | None = None,
             mapping: Mapping | None = None, *,
             engine: str | None = None,
             compute=None,
             precomputed: tuple | None = None,
             sparsity_profile=None) -> SimReport:
    """Run the network on the simulated chip and price every timestep.

    Args:
      engine: "batched" (layer-major, default) or "reference" (step-major).
      compute: per-layer synaptic backend — ``"dense"`` (default),
        ``"event"``, or a :class:`~repro_torch.neuromorphic.compute.
        LayerCompute` instance.  Counters (and so the report) are exact
        across backends.
      precomputed: a cached ``net.run_batch(xs)`` result to reuse (batched
        engine only; takes precedence over ``compute``).
      sparsity_profile: a trained :class:`~repro_torch.sparsity.profile.
        SparsityProfile` to program onto ``net`` (its ``apply``) before
        the run: message gates and weight masks; the pricing math is
        untouched.  Mutually exclusive with ``precomputed``.
    """
    engine = engine or DEFAULT_ENGINE
    net = apply_profile(net, sparsity_profile, precomputed=precomputed)
    part = part or minimal_partition(net, profile)
    mapping = mapping or ordered_mapping(part, profile)
    if engine == "batched":
        return _simulate_batched(net, xs, profile, part, mapping, precomputed,
                                 compute)
    if engine == "reference":
        return _simulate_reference(net, xs, profile, part, mapping, compute)
    raise ValueError(f"unknown engine {engine!r}")


def _finish_report(net, part, T, times, energies, outputs, mean_synops,
                   mean_acts, mean_msgs, max_synops_steps, max_acts_steps,
                   max_link_steps, total_msgs, total_neuron_steps,
                   stage_votes) -> SimReport:
    """Shared report assembly for both engines (identical float math)."""
    w_nnz = sum(l.w_nnz for l in net.layers)
    w_cap = sum(l.n_weights for l in net.layers)
    total_msgs = float(total_msgs)
    metrics = WorkloadMetrics(
        synops=LoadStats.of(_host(mean_synops)),
        acts=LoadStats.of(_host(mean_acts)),
        traffic=LoadStats.of(np.array([float(max_link_steps.mean())])),
        msgs_total=total_msgs / T,
        weight_density=w_nnz / max(w_cap, 1),
        act_density=(total_msgs / max(float(total_neuron_steps), 1.0)),
    )
    bottleneck = max(stage_votes.items(), key=lambda kv: kv[1])[0]
    return SimReport(
        time_per_step=float(times.mean()),
        energy_per_step=float(energies.mean()),
        times=times, energies=energies, metrics=metrics,
        max_synops=float(max_synops_steps.mean()),
        max_acts=float(max_acts_steps.mean()),
        max_link_load=float(max_link_steps.mean()),
        n_cores_active=part.total_cores,
        outputs=outputs,
        per_core_synops=mean_synops,
        per_core_acts=mean_acts,
        per_core_msgs_out=mean_msgs,
        bottleneck_stage=bottleneck,
    )


@dataclasses.dataclass
class LayerPricing:
    """Partition/mapping-independent pricing state for one layer: float64
    neuron-axis cumulative sums of every counter map, so any core
    boundary's segment sum is a two-point gather (an empty segment sums to
    exactly 0)."""

    msgs_in: torch.Tensor      # (T,)
    csum_macs: torch.Tensor    # (T, n_neurons + 1)
    csum_fetches: torch.Tensor
    csum_acts: torch.Tensor    # of the profile's acts map
    csum_msgs: torch.Tensor
    n_neurons: int
    sparse: bool


@dataclasses.dataclass
class PricingCache:
    """Everything :func:`price_candidate` needs that does not depend on
    the candidate: the functional outputs plus per-layer pricing state.
    ``device_pricer`` lazily holds the population pricer of the
    ``backend="device"`` path (a cache is bound to one workload)."""

    outputs: torch.Tensor
    T: int
    layers: list[LayerPricing]
    device_pricer: object = dataclasses.field(default=None, repr=False,
                                              compare=False)


def _neuron_csum(per_neuron: torch.Tensor) -> torch.Tensor:
    """(T, n) -> (T, n+1) float64 cumulative sum with a leading zero
    column."""
    a = per_neuron.to(_F64)
    return torch.cat([torch.zeros((a.shape[0], 1), dtype=_F64,
                                  device=a.device),
                      torch.cumsum(a, dim=1)], dim=1)


def precompute_pricing(net: SimNetwork, xs, profile: ChipProfile, *,
                       precomputed: tuple | None = None,
                       compute=None, sparsity_profile=None) -> PricingCache:
    """Run the functional network (or reuse a cached ``net.run_batch(xs)``
    result) and reduce its counter maps to per-layer cumsums; one cache
    prices any number of (partition, mapping) candidates.
    ``sparsity_profile`` programs a trained profile onto ``net`` before the
    run (mutually exclusive with ``precomputed``)."""
    net = apply_profile(net, sparsity_profile, precomputed=precomputed)
    outputs, all_counters = precomputed or net.run_batch(xs, compute=compute)
    layers = []
    for l, counters in enumerate(all_counters):
        acts_map = (counters.acts_evented if not profile.synchronous
                    else torch.ones_like(counters.macs))
        layers.append(LayerPricing(
            msgs_in=counters.msgs_in.to(_F64),
            csum_macs=_neuron_csum(counters.macs),
            csum_fetches=_neuron_csum(counters.fetches_dense),
            csum_acts=_neuron_csum(acts_map),
            csum_msgs=_neuron_csum(counters.msgs_out),
            n_neurons=net.layers[l].n_neurons,
            sparse=_layer_format(net.layers[l], profile)))
    return PricingCache(outputs=outputs, T=int(outputs.shape[0]),
                        layers=layers)


def _seg(csum: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(T, cores) segment sums from cached cumsums."""
    return csum[:, bounds[1:]] - csum[:, bounds[:-1]]


def _cached_layer_counters(lp: LayerPricing, part: Partition, layer_idx: int,
                           T: int) -> BatchCoreCounters:
    """All-timesteps analog of :func:`aggregate_layer`, built from a
    :class:`LayerPricing`."""
    bounds = _bounds(part, layer_idx, lp.n_neurons, lp.csum_macs.device)
    macs = _seg(lp.csum_macs, bounds)
    fetches_dense = _seg(lp.csum_fetches, bounds)
    c = part.cores[layer_idx]
    return BatchCoreCounters(
        msgs_in=lp.msgs_in[:, None].expand(T, c),
        synops=macs if lp.sparse else fetches_dense,
        macs=macs,
        acts=_seg(lp.csum_acts, bounds),
        msgs_out=_seg(lp.csum_msgs, bounds),
        neurons=torch.diff(bounds).to(_F64),
        sparse_format=lp.sparse,
    )


def _simulate_batched(net: SimNetwork, xs, profile: ChipProfile,
                      part: Partition, mapping: Mapping,
                      precomputed: tuple | None, compute=None) -> SimReport:
    """Layer-major engine: one pricing-cache build + one candidate."""
    cache = precompute_pricing(net, xs, profile, precomputed=precomputed,
                               compute=compute)
    return price_candidate(net, profile, cache, part, mapping)


def _rowmax(a: torch.Tensor) -> torch.Tensor:
    """Per-step max over cores with NumPy's ``initial=0.0``."""
    return a.amax(dim=1).clamp_min(0.0)


def price_candidate(net: SimNetwork, profile: ChipProfile,
                    cache: PricingCache, part: Partition,
                    mapping: Mapping) -> SimReport:
    """Price one (partition, mapping) candidate from a pricing cache; every
    per-step quantity is a (T, ...) float64 tensor."""
    T = cache.T
    n_logical = part.total_cores
    layer_cc = [_cached_layer_counters(cache.layers[l], part, l, T)
                for l in range(len(cache.layers))]
    dev = cache.layers[0].csum_macs.device

    mem_all, act_all = [], []
    e_events = torch.zeros(T, dtype=_F64, device=dev)
    total_msgs = torch.zeros((), dtype=_F64, device=dev)
    total_neuron_steps = torch.zeros((), dtype=_F64, device=dev)
    for l, cc in enumerate(layer_cc):
        mem, act = core_times(cc, net.layers[l].neuron_model, profile)
        mem_all.append(mem)
        act_all.append(act)
        # event energies: fetch every (format-effective) synop; MAC energy
        # only on nonzero weights
        e = (profile.e_fetch * cc.synops.sum(dim=1)
             + profile.e_mac * cc.macs.sum(dim=1))
        if cc.sparse_format:
            e = e + profile.e_decode * cc.synops.sum(dim=1)
        e_events += (e + profile.e_act * cc.acts.sum(dim=1)
                     * (profile.neuron_cost(net.layers[l].neuron_model)
                        / profile.c_act))
        total_msgs += cc.msgs_out.sum()
        total_neuron_steps += T * cc.neurons.sum()

    synops_all = torch.cat([cc.synops for cc in layer_cc], dim=1)
    acts_all = torch.cat([cc.acts for cc in layer_cc], dim=1)
    msgs_all = torch.cat([cc.msgs_out for cc in layer_cc], dim=1)

    traffic = route_batch(part, mapping, msgs_all, profile)
    mem_cat = torch.cat(mem_all, dim=1)             # (T, n_logical)
    act_cat = torch.cat(act_all, dim=1)
    core_time = torch.maximum(mem_cat, act_cat) + profile.t_core_fixed
    # Congestion: the busiest router serializes every packet touching it;
    # cores also serialize their own (duplicated) injections.
    max_link_steps = traffic.max_router_load        # (T,)
    traffic_time = (profile.c_route * max_link_steps
                    + profile.c_inject * _rowmax(traffic.inject_per_core))

    stage_votes = {"memory": 0, "compute": 0, "traffic": 0, "barrier": 0}
    if profile.synchronous:
        t_compute = _rowmax(core_time)
        times = torch.maximum(t_compute, traffic_time) + profile.t_barrier
        traffic_bound = traffic_time > t_compute
        mem_bound = _rowmax(mem_cat) >= _rowmax(act_cat)
        stage_votes["traffic"] = int(traffic_bound.sum())
        stage_votes["memory"] = int((~traffic_bound & mem_bound).sum())
        stage_votes["compute"] = int((~traffic_bound & ~mem_bound).sum())
    else:
        # async pipeline: sample latency = sum over layers of the layer's
        # slowest event-driven core + NoC transit
        times = torch.zeros(T, dtype=_F64, device=dev)
        for m, a in zip(mem_all, act_all):
            times = times + _rowmax(torch.maximum(m, a))
        times = times + (profile.c_msg_hop * traffic.total_hops
                         / max(part.total_cores, 1))
        stage_votes["memory"] = T

    n_active = ((synops_all + msgs_all) > 0).sum(dim=1).to(_F64)
    n_active[n_active == 0] = n_logical
    e_hops = profile.e_msg_hop * traffic.total_hops
    energies = (times * (profile.p_idle + profile.p_core * n_active)
                + e_events + e_hops)

    return _finish_report(
        net, part, T, times, energies, cache.outputs,
        synops_all.sum(dim=0) / T, acts_all.sum(dim=0) / T,
        msgs_all.sum(dim=0) / T,
        max_synops_steps=_rowmax(synops_all),
        max_acts_steps=_rowmax(acts_all),
        max_link_steps=max_link_steps,
        total_msgs=total_msgs, total_neuron_steps=total_neuron_steps,
        stage_votes=stage_votes)


# ---------------------------------------------------------------- population

#: The population backends :func:`simulate_population` takes.  ``"vmap"``
#: and ``"sharded"`` (the JAX package's jitted-vmap and device-mesh
#: pricers) are not ported: the batched ``"device"`` program takes the
#: place of ``"vmap"``, and a sharded pricer waits for the
#: ``core/device_search.py`` item of ROADMAP queue 1.
POPULATION_BACKENDS = ("numpy", "device")


def population_pad_width(net: SimNetwork, profile: ChipProfile) -> int:
    """Logical-core padding width for (net, profile): every feasible
    candidate fits."""
    cap = sum(min(max_cores_for_layer(net, l), profile.n_cores)
              for l in range(len(net.layers)))
    return min(cap, profile.n_cores)


def simulate_population(net: SimNetwork, xs, profile: ChipProfile,
                        candidates, *, precomputed: tuple | None = None,
                        cache: PricingCache | None = None,
                        backend: str = "numpy", compute=None,
                        sparsity_profile=None) -> list[SimReport]:
    """Price many (partition, mapping) candidates from ONE functional run.

    ``candidates`` is an iterable of ``(Partition, Mapping)`` pairs.  The
    functional run and the per-layer counter cumsums happen once (or come
    from ``cache`` / ``precomputed``); then:

    * ``backend="numpy"`` — each candidate is priced by
      :func:`price_candidate`, the batched engine's own pricer, so every
      report is bit-identical to ``simulate(net, xs, profile, part,
      mapping)``.  (The JAX package first gathers the whole population's
      segment sums in one stacked indexing operation; the port keeps the
      one pricing path.)
    * ``backend="device"`` — the candidates become stacked genome rows,
      (K, n_layers) core counts and (K, n_slots) slot permutations, and
      one batched float64 program derives every candidate's segment
      bounds and NoC structures and prices them all
      (:func:`price_population_device`).  Agrees with ``"numpy"`` to
      float64 roundoff (rtol 1e-9): sums run in another order.

    ``"vmap"`` and ``"sharded"`` raise ``NotImplementedError``.
    ``sparsity_profile`` programs a trained profile onto ``net`` before the
    functional run (mutually exclusive with ``cache`` / ``precomputed``,
    which are bound to the un-profiled network).
    """
    net = apply_profile(net, sparsity_profile, cache=cache,
                        precomputed=precomputed)
    if backend in ("vmap", "sharded"):
        raise NotImplementedError(
            f"population backend {backend!r} is not ported (ROADMAP queue "
            "1, the core/device_search.py item): use 'numpy' or 'device'")
    if backend not in POPULATION_BACKENDS:
        raise ValueError(f"unknown population backend {backend!r}")
    cands = list(candidates)
    if not cands:
        return []
    for k, (part, mapping) in enumerate(cands):
        if len(mapping.phys) != part.total_cores:
            raise ValueError(
                f"candidate {k}: mapping places {len(mapping.phys)} logical "
                f"cores but the partition allocates {part.total_cores} "
                f"(cores={tuple(part.cores)}); partition and mapping must "
                "agree before pricing")
    cache = cache or precompute_pricing(net, xs, profile,
                                        precomputed=precomputed,
                                        compute=compute)
    if backend == "device":
        cores, perm = _pairs_to_rows(cands, len(cache.layers),
                                     profile.n_cores)
        return price_population_device(net, profile, cache, cores, perm)
    return [price_candidate(net, profile, cache, p, m) for p, m in cands]


def _pairs_to_rows(pairs, n_layers: int,
                   n_slots: int) -> tuple[np.ndarray, np.ndarray]:
    """(Partition, Mapping) pairs -> stacked fixed-shape genome rows:
    (K, n_layers) core counts and (K, n_slots) slot permutations whose
    tail (the unexpressed slots) is filled ascending."""
    K = len(pairs)
    cores = np.zeros((K, n_layers), np.int64)
    perm = np.zeros((K, n_slots), np.int64)
    for k, (part, mapping) in enumerate(pairs):
        cores[k] = part.cores
        used = [int(p) for p in mapping.phys]
        taken = set(used)
        perm[k] = used + [s for s in range(n_slots) if s not in taken]
    return cores, perm


#: Largest (candidates x T x padded cores) block the device pricer works
#: on at once; a larger population is priced in row blocks of this size
#: (pricing is row-independent, so the blocks' results are the same).
_BLOCK_ELEMS = 1 << 24


class PopulationPricer:
    """Batched population pricer bound to one :class:`PricingCache`.

    Holds the workload's constants on the cache's device — the counter
    cumsums of every layer concatenated, per-layer cost coefficients, the
    routing geometry — and prices stacked genome rows: ``cores`` (K,
    n_layers) and ``perm`` (K, n_slots).  A candidate's segment bounds,
    layer ids, routers and NoC structures are all derived from its rows
    on the device; the K axis is written out (it is the JAX package's
    ``vmap`` axis).  Boundaries reproduce ``np.linspace(0, n, c + 1)
    .astype(int)`` exactly: ``int(i * (n / c))`` in float64, the last one
    pinned to ``n``."""

    def __init__(self, net: SimNetwork, profile: ChipProfile,
                 cache: PricingCache):
        p = self.profile = profile
        self.T = cache.T
        self.n_layers = len(cache.layers)
        self.n_pad = population_pad_width(net, profile)
        self.cpr = cores_per_router(profile)
        self.weight_density = (sum(l.w_nnz for l in net.layers)
                               / max(sum(l.n_weights for l in net.layers),
                                     1))
        dev = self.device = cache.layers[0].csum_macs.device
        # per-layer coefficients, folded with the same Python-float
        # arithmetic as core_times() and price_candidate()
        mem_msg, mem_syn, ncost, sparse_f, e_act_c = [], [], [], [], []
        for l, lp in enumerate(cache.layers):
            model = net.layers[l].neuron_model
            if lp.sparse:
                mem_msg.append(p.c_msg_recv + p.c_decode_msg)
                mem_syn.append(p.c_fetch + p.c_decode_word + p.c_mac)
            else:
                mem_msg.append(p.c_msg_recv)
                mem_syn.append(p.c_fetch + p.c_mac)
            ncost.append(p.neuron_cost(model))
            sparse_f.append(1.0 if lp.sparse else 0.0)
            e_act_c.append(p.e_act * (p.neuron_cost(model) / p.c_act))
        on = lambda v: torch.as_tensor(v, dtype=_F64, device=dev)
        self.coefs = tuple(on(v) for v in (mem_msg, mem_syn, ncost,
                                           sparse_f, e_act_c))
        self.csums = tuple(torch.cat([getattr(lp, f) for lp in cache.layers],
                                     dim=1)
                           for f in ("csum_macs", "csum_fetches",
                                     "csum_acts", "csum_msgs"))
        self.msgs_in = torch.stack([lp.msgs_in for lp in cache.layers],
                                   dim=1)                     # (T, L)
        widths = [lp.n_neurons + 1 for lp in cache.layers]
        self.block_off = torch.as_tensor(
            np.concatenate([[0], np.cumsum(widths)])[:-1], device=dev)
        self.n_neurons = torch.as_tensor(
            [lp.n_neurons for lp in cache.layers], device=dev)
        self.inc3, self.hops2 = (on(t) for t in incidence_tables(
            profile.grid))

    def structures(self, cores: torch.Tensor, perm: torch.Tensor):
        """(K, n_layers) cores + (K, n_slots) perm -> the padded (K, Ncap)
        per-core pricing structures: live mask, layer ids, cumsum gather
        bounds, neurons per core, and the NoC ``(PL, ph, dup)``."""
        L, ncap = self.n_layers, self.n_pad
        K = cores.shape[0]
        csum = torch.cumsum(cores, dim=1)                         # (K, L)
        j = torch.arange(ncap, device=cores.device).repeat(K, 1)
        alive = j < csum[:, -1:]
        lid = torch.searchsorted(csum, j, right=True).clamp_max(L - 1)
        within = j - (csum - cores).gather(1, lid)                # in layer
        n_l = self.n_neurons[lid]
        c_l = cores.gather(1, lid)
        # the same float64 arithmetic as np.linspace(0, n, c+1).astype(int)
        step = n_l.to(_F64) / c_l.to(_F64)
        lo_loc = (within.to(_F64) * step).to(torch.int64)
        hi_loc = torch.where(within + 1 == c_l, n_l,
                             ((within + 1).to(_F64) * step).to(torch.int64))
        zero = torch.zeros((), dtype=torch.int64, device=cores.device)
        lid = torch.where(alive, lid, zero)
        seg_lo = torch.where(alive, self.block_off[lid] + lo_loc, zero)
        seg_hi = torch.where(alive, self.block_off[lid] + hi_loc, zero)
        neurons = torch.where(alive, hi_loc - lo_loc, zero).to(_F64)
        mask = alive.to(_F64)
        router = torch.where(alive, perm[:, :ncap] // self.cpr, zero)
        PL, ph, dup = flow_structures_rows(lid, router, mask, L, self.inc3,
                                           self.hops2)
        return mask, lid, seg_lo, seg_hi, neurons, PL, ph, dup

    def price(self, cores: torch.Tensor, perm: torch.Tensor) -> dict:
        """Price stacked int64 genome rows on the pricer's device; returns
        a dict of tensors there with a leading population axis."""
        rows = max(1, _BLOCK_ELEMS // (self.T * self.n_pad))
        parts = [self._price_block(cores[i:i + rows], perm[i:i + rows])
                 for i in range(0, cores.shape[0], rows)]
        return {k: torch.cat([o[k] for o in parts]) for k in parts[0]}

    def _price_block(self, cores: torch.Tensor, perm: torch.Tensor) -> dict:
        p = self.profile
        T = self.T
        mask, lid, seg_lo, seg_hi, neurons, PL, ph, dup = \
            self.structures(cores, perm)
        mem_msg, mem_syn, ncost, sparse_f, e_act_c = self.coefs

        def seg(cs):                                      # (K, T, Ncap)
            return (cs[:, seg_hi] - cs[:, seg_lo]).permute(1, 0, 2)

        macs, fetches, acts, msgs = (seg(cs) for cs in self.csums)
        sp_c = sparse_f[lid][:, None, :]                  # (K, 1, Ncap)
        synops = torch.where(sp_c > 0, macs, fetches)
        live = mask[:, None, :]
        msgs_in_c = self.msgs_in[:, lid].permute(1, 0, 2) * live
        mem = msgs_in_c * mem_msg[lid][:, None, :] \
            + synops * mem_syn[lid][:, None, :]
        act = acts * ncost[lid][:, None, :]
        core_time = (torch.maximum(mem, act) + p.t_core_fixed) * live

        e_events = (p.e_fetch * synops.sum(dim=2)
                    + p.e_mac * macs.sum(dim=2)
                    + p.e_decode * (synops * sp_c).sum(dim=2)
                    + (acts * e_act_c[lid][:, None, :]).sum(dim=2))

        loads = torch.bmm(msgs, PL)                       # (K, T, R)
        hops = torch.bmm(msgs, ph[..., None])[..., 0]     # (K, T)
        inject = msgs * dup[:, None, :]
        max_link = loads.amax(dim=2)
        traffic_time = (p.c_route * max_link
                        + p.c_inject * inject.amax(dim=2))

        n_logical = mask.sum(dim=1)                       # (K,)
        zeros = torch.zeros_like(n_logical, dtype=torch.int64)
        if p.synchronous:
            t_compute = core_time.amax(dim=2)
            times = torch.maximum(t_compute, traffic_time) + p.t_barrier
            tb = traffic_time > t_compute
            mb = mem.amax(dim=2) >= act.amax(dim=2)
            votes = torch.stack([(~tb & mb).sum(dim=1),
                                 (~tb & ~mb).sum(dim=1), tb.sum(dim=1),
                                 zeros], dim=1)
        else:
            val = torch.maximum(mem, act) * live
            K = val.shape[0]
            per_layer = torch.zeros((K, T, self.n_layers), dtype=_F64,
                                    device=val.device).scatter_reduce(
                2, lid[:, None, :].expand_as(val), val, "amax")
            times = (per_layer.sum(dim=2)
                     + p.c_msg_hop * hops
                     / n_logical.clamp_min(1.0)[:, None])
            votes = torch.stack([zeros + T, zeros, zeros, zeros], dim=1)

        n_active = (((synops + msgs) > 0) & (live > 0)).sum(dim=2).to(_F64)
        n_active = torch.where(n_active == 0, n_logical[:, None], n_active)
        energies = (times * (p.p_idle + p.p_core * n_active)
                    + e_events + p.e_msg_hop * hops)

        mean_synops = synops.sum(dim=1) / T               # (K, Ncap)
        mean_acts = acts.sum(dim=1) / T
        mean_msgs = msgs.sum(dim=1) / T
        return dict(
            times=times, energies=energies,
            time_per_step=times.mean(dim=1),
            energy_per_step=energies.mean(dim=1),
            max_synops=synops.amax(dim=2).mean(dim=1),
            max_acts=acts.amax(dim=2).mean(dim=1),
            max_link_load=max_link.mean(dim=1),
            mean_synops=mean_synops, mean_acts=mean_acts,
            mean_msgs=mean_msgs,
            syn_total=mean_synops.sum(dim=1),
            syn_max=mean_synops.amax(dim=1),
            syn_nact=(mean_synops > 0).sum(dim=1),
            act_total=mean_acts.sum(dim=1), act_max=mean_acts.amax(dim=1),
            act_nact=(mean_acts > 0).sum(dim=1),
            votes=votes, total_msgs=msgs.sum(dim=(1, 2)),
            total_neuron_steps=T * neurons.sum(dim=1))


def _rows(a, device: torch.device) -> torch.Tensor:
    """Genome rows (a numpy array or a tensor anywhere) as int64 on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def price_population_device(net: SimNetwork, profile: ChipProfile,
                            cache: PricingCache, cores,
                            perm) -> list[SimReport]:
    """Price stacked genome rows — ``cores`` (K, n_layers), ``perm`` (K,
    n_slots), host or device arrays — with the cache's
    :class:`PopulationPricer` (built on first use) and assemble the
    reports."""
    n_layers, n_slots = len(cache.layers), int(profile.n_cores)
    if (np.ndim(cores) != 2 or np.ndim(perm) != 2
            or cores.shape[1] != n_layers or perm.shape[1] != n_slots
            or cores.shape[0] != perm.shape[0]):
        raise ValueError(
            f"genome rows must be cores (K, {n_layers}) and perm "
            f"(K, {n_slots}) for this (network, profile); got "
            f"cores {tuple(np.shape(cores))} and perm "
            f"{tuple(np.shape(perm))}")
    if cache.device_pricer is None:
        cache.device_pricer = PopulationPricer(net, profile, cache)
    pricer: PopulationPricer = cache.device_pricer
    cores = _rows(cores, pricer.device)
    out = pricer.price(cores, _rows(perm, pricer.device))
    return _assemble_reports(out, _host(cores.sum(dim=1)), cache,
                             pricer.weight_density)


_STAGES = ("memory", "compute", "traffic", "barrier")
_SCALARS = ("time_per_step", "energy_per_step", "max_synops", "max_acts",
            "max_link_load", "syn_total", "syn_max", "syn_nact",
            "act_total", "act_max", "act_nact", "votes", "total_msgs",
            "total_neuron_steps")


def _assemble_reports(out: dict, n_logical: np.ndarray, cache: PricingCache,
                      w_density: float) -> list[SimReport]:
    """One :class:`SimReport` per candidate from the pricer's batched
    dict.  The scalar fields come to the host in one transfer each; the
    per-step and per-core arrays stay on the device, as views of the
    batch."""
    T = cache.T
    h = {k: _host(out[k]) for k in _SCALARS}

    def stats(total, mx, n_act, n):
        total, mx, n_act = float(total), float(mx), int(n_act)
        mean = total / max(n_act, 1)
        return LoadStats(total=total, max=mx, mean=mean,
                         imbalance=(mx / mean) if mean > 0 else 1.0,
                         n_units=n, n_active=n_act)

    reports = []
    for k, n in enumerate(int(v) for v in n_logical):
        link = float(h["max_link_load"][k])
        total_msgs = float(h["total_msgs"][k])
        metrics = WorkloadMetrics(
            synops=stats(h["syn_total"][k], h["syn_max"][k],
                         h["syn_nact"][k], n),
            acts=stats(h["act_total"][k], h["act_max"][k],
                       h["act_nact"][k], n),
            traffic=LoadStats(total=link, max=link,
                              mean=link if link > 0 else 0.0,
                              imbalance=1.0, n_units=1,
                              n_active=int(link > 0)),
            msgs_total=total_msgs / T,
            weight_density=w_density,
            act_density=(total_msgs
                         / max(float(h["total_neuron_steps"][k]), 1.0)))
        reports.append(SimReport(
            time_per_step=float(h["time_per_step"][k]),
            energy_per_step=float(h["energy_per_step"][k]),
            times=out["times"][k], energies=out["energies"][k],
            metrics=metrics,
            max_synops=float(h["max_synops"][k]),
            max_acts=float(h["max_acts"][k]),
            max_link_load=link, n_cores_active=n, outputs=cache.outputs,
            per_core_synops=out["mean_synops"][k, :n],
            per_core_acts=out["mean_acts"][k, :n],
            per_core_msgs_out=out["mean_msgs"][k, :n],
            bottleneck_stage=_STAGES[int(np.argmax(h["votes"][k]))]))
    return reports


@dataclasses.dataclass(frozen=True)
class LayerStageTimes:
    """Per-layer floorline coordinates (one row per network layer):
    mean-over-steps memory/compute stage times of the layer's slowest core,
    its share of the NoC serialization time (by message volume), and its
    mean messages per step."""

    name: str
    mem_time: float
    act_time: float
    traffic_time: float
    msgs_out: float

    @property
    def total_time(self) -> float:
        return max(self.mem_time, self.act_time) + self.traffic_time


def layer_stage_times(net: SimNetwork, xs, profile: ChipProfile,
                      part: Partition | None = None,
                      mapping: Mapping | None = None, *,
                      cache: PricingCache | None = None
                      ) -> list[LayerStageTimes]:
    """Decompose a priced workload into per-layer stage times, using the
    pricer's counter segments and stage formulas."""
    part = part or minimal_partition(net, profile)
    mapping = mapping or ordered_mapping(part, profile)
    cache = cache or precompute_pricing(net, xs, profile)
    T = cache.T
    layer_cc = [_cached_layer_counters(cache.layers[l], part, l, T)
                for l in range(len(cache.layers))]
    msgs_all = torch.cat([cc.msgs_out for cc in layer_cc], dim=1)
    traffic = route_batch(part, mapping, msgs_all, profile)
    traffic_time = (profile.c_route * traffic.max_router_load
                    + profile.c_inject * _rowmax(traffic.inject_per_core))
    layer_msgs = np.array([float(cc.msgs_out.sum()) for cc in layer_cc],
                          np.float64)
    share = layer_msgs / max(layer_msgs.sum(), 1.0)
    out = []
    for l, cc in enumerate(layer_cc):
        mem, act = core_times(cc, net.layers[l].neuron_model, profile)
        out.append(LayerStageTimes(
            name=net.layers[l].name,
            mem_time=float(_rowmax(mem).mean()),
            act_time=float(_rowmax(act).mean()),
            traffic_time=float(traffic_time.mean() * share[l]),
            msgs_out=float(layer_msgs[l] / T)))
    return out


def _simulate_reference(net: SimNetwork, xs, profile: ChipProfile,
                        part: Partition, mapping: Mapping,
                        compute=None) -> SimReport:
    """Step-major reference engine: per-step host arithmetic on the same
    per-core float64 segment sums, in the same op order as the batched
    engine (bit-identical times and energies)."""
    outputs, all_counters = net.run(xs, compute=compute)
    T = int(outputs.shape[0])
    n_layers = len(net.layers)
    n_logical = part.total_cores
    dev = outputs.device
    times = np.zeros(T)
    energies = np.zeros(T)
    sum_core_synops = torch.zeros(n_logical, dtype=_F64, device=dev)
    sum_core_acts = torch.zeros(n_logical, dtype=_F64, device=dev)
    sum_core_msgs = torch.zeros(n_logical, dtype=_F64, device=dev)
    max_synops_steps = np.zeros(T)
    max_acts_steps = np.zeros(T)
    max_link_steps = np.zeros(T)
    stage_votes = {"memory": 0, "compute": 0, "traffic": 0, "barrier": 0}
    total_msgs = 0.0
    total_neuron_steps = 0.0

    offsets = np.concatenate([[0], np.cumsum(part.cores)]).astype(int)

    for t in range(T):
        layer_cc = [aggregate_layer(all_counters[t][l], l, part, net, profile)
                    for l in range(n_layers)]
        mem_all, act_all = [], []
        msgs_out_per_core = []
        e_events = 0.0
        for l, cc in enumerate(layer_cc):
            mem, act = core_times(cc, net.layers[l].neuron_model, profile)
            mem_all.append(mem)
            act_all.append(act)
            msgs_out_per_core.append(cc.msgs_out)
            sl = slice(offsets[l], offsets[l + 1])
            sum_core_synops[sl] += cc.synops
            sum_core_acts[sl] += cc.acts
            sum_core_msgs[sl] += cc.msgs_out
            e = (profile.e_fetch * float(cc.synops.sum())
                 + profile.e_mac * float(cc.macs.sum()))
            if cc.sparse_format:
                e = e + profile.e_decode * float(cc.synops.sum())
            e_events += (e + profile.e_act * float(cc.acts.sum())
                         * (profile.neuron_cost(net.layers[l].neuron_model)
                            / profile.c_act))
            total_msgs += float(cc.msgs_out.sum())
            total_neuron_steps += float(cc.neurons.sum())

        traffic = route_step(part, mapping, msgs_out_per_core, profile)
        mem_cat = torch.cat(mem_all)
        act_cat = torch.cat(act_all)
        core_time = torch.maximum(mem_cat, act_cat) + profile.t_core_fixed
        traffic_time = (profile.c_route * traffic.max_router_load
                        + profile.c_inject
                        * max(float(traffic.inject_per_core.max()), 0.0))

        if profile.synchronous:
            t_compute = max(float(core_time.max()), 0.0)
            t_step = max(t_compute, traffic_time) + profile.t_barrier
            which = ("traffic" if traffic_time > t_compute else
                     ("memory" if max(float(mem_cat.max()), 0.0)
                      >= max(float(act_cat.max()), 0.0) else "compute"))
        else:
            per_layer = [max(float(torch.maximum(m, a).max()), 0.0)
                         for m, a in zip(mem_all, act_all)]
            t_step = sum(per_layer) + profile.c_msg_hop * float(
                traffic.total_hops) / max(part.total_cores, 1)
            which = "memory"

        n_active = int(((torch.cat([cc.synops + cc.msgs_out
                                    for cc in layer_cc])) > 0).sum()) \
            or n_logical
        e_hops = profile.e_msg_hop * float(traffic.total_hops)
        energies[t] = (t_step * (profile.p_idle + profile.p_core * n_active)
                       + e_events + e_hops)
        times[t] = t_step
        stage_votes[which] += 1
        max_synops_steps[t] = max(float(torch.cat(
            [cc.synops for cc in layer_cc]).max()), 0.0)
        max_acts_steps[t] = max(float(torch.cat(
            [cc.acts for cc in layer_cc]).max()), 0.0)
        max_link_steps[t] = traffic.max_router_load

    on_dev = lambda a: torch.as_tensor(a, dtype=_F64, device=dev)
    return _finish_report(
        net, part, T, on_dev(times), on_dev(energies), outputs,
        mean_synops=sum_core_synops / T,
        mean_acts=sum_core_acts / T,
        mean_msgs=sum_core_msgs / T,
        max_synops_steps=on_dev(max_synops_steps),
        max_acts_steps=on_dev(max_acts_steps),
        max_link_steps=on_dev(max_link_steps),
        total_msgs=total_msgs, total_neuron_steps=total_neuron_steps,
        stage_votes=stage_votes)
