"""Floorline-informed partitioning & mapping optimization (paper §VI-B).

The paper's stage-2 procedure:

1. Initialize at the minimum neurocore utilization with a good heuristic
   (strided) mapping — likely memory-bound.
2. **Memory assumption**: find the core with the most synops, partition its
   layer further; keep a move only if the step helps, else backtrack.
3. **Compute assumption**: same loop keyed on max activation computes.
4. **Traffic assumption**: improve the mapping (move the highest-output
   cores onto separate router paths).
5. Cycle through the assumptions; stop when out of cores, or when no
   assumption yields improvement.

The evaluator is any callable (partition, mapping) -> SimReport;
:class:`SimEvaluator` builds the batched engine's pricing cache once and
prices every candidate from it, counting evaluations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.analytical import Bottleneck
from repro_torch.core.resilience import FallbackChain
from repro_torch.neuromorphic import timestep
from repro_torch.neuromorphic.network import SimNetwork
from repro_torch.neuromorphic.noc import (Mapping, cores_per_router,
                                          n_router_tiles, strided_mapping)
from repro_torch.neuromorphic.partition import (Partition,
                                                max_cores_for_layer,
                                                minimal_partition,
                                                validate_partition)
from repro_torch.neuromorphic.platform import ChipProfile
from repro_torch.neuromorphic.timestep import (SimReport, precompute_pricing,
                                               price_candidate, simulate,
                                               simulate_population)

#: Anything that prices a (partition, mapping) candidate.
Evaluator = Callable[[Partition, Mapping], SimReport]


class SimEvaluator:
    """Evaluation-counting pricing gateway for one (net, xs, profile)
    workload.  With the batched engine the functional run and per-layer
    counter cumsums are computed once, on the network's device, and every
    candidate is priced from that cache; ``engine="reference"`` prices
    each candidate with the step-major engine instead (identical results).
    ``n_evals`` counts priced candidates, the budget unit shared by the
    greedy walk and the evolutionary search.

    ``population_backend`` selects how :meth:`evaluate_population` prices
    a population: ``"numpy"`` (per candidate, bit-identical to
    ``simulate``), ``"vmap"`` (``torch.func.vmap`` of one candidate's
    pricer) or ``"device"`` (one batched program); the last two agree
    with ``"numpy"`` to float64 roundoff.

    ``sparsity_profile`` programs a trained
    :class:`~repro_torch.sparsity.profile.SparsityProfile` onto ``net``
    once, here, before the functional run; it cannot be combined with a
    shared ``cache``, which is bound to the un-profiled network.

    Population pricing degrades gracefully: a backend failure is retried
    per ``retry`` and then demoted down the ``device -> vmap -> numpy``
    chain
    (:class:`~repro_torch.core.resilience.FallbackChain`; sticky, logged,
    recorded in :attr:`demotions`).  The chain wraps population pricing
    only, never the functional run: a kernel that fails to build or launch
    still raises.  ``fallback=False`` fails fast.  ``fault_plan`` is the
    deterministic fault-injection hook (:class:`~repro_torch.core.
    resilience.FaultPlan`)."""

    def __init__(self, net: SimNetwork, xs, profile: ChipProfile, *,
                 engine: str | None = None, cache=None,
                 population_backend: str = "numpy", compute=None,
                 fault_plan=None, fallback: bool = True, retry=None,
                 sparsity_profile=None):
        net = timestep.apply_profile(net, sparsity_profile, cache=cache)
        self.sparsity_profile = sparsity_profile
        self.net, self.xs, self.profile = net, xs, profile
        self.engine = engine or timestep.DEFAULT_ENGINE
        self.population_backend = population_backend
        #: per-layer synaptic backend of the functional run
        self.compute = compute
        self.cache = (cache or precompute_pricing(net, xs, profile,
                                                  compute=compute)
                      if self.engine == "batched" else None)
        self.n_evals = 0
        self.fault_plan = fault_plan
        self._chain = (FallbackChain(population_backend, retry=retry)
                       if fallback else None)

    @property
    def demotions(self) -> list:
        """Fallback-chain demotion records, oldest first (empty when the
        chain is disabled or never fired)."""
        return self._chain.demotions if self._chain is not None else []

    @property
    def active_backend(self) -> str:
        """The population backend in use (differs from
        ``population_backend`` after a demotion)."""
        return (self._chain.backend if self._chain is not None
                else self.population_backend)

    def __call__(self, part: Partition, mapping: Mapping) -> SimReport:
        self.n_evals += 1
        if self.cache is not None:
            return price_candidate(self.net, self.profile, self.cache,
                                   part, mapping)
        return simulate(self.net, self.xs, self.profile, part, mapping,
                        engine=self.engine, compute=self.compute)

    def evaluate_population(self, candidates) -> list[SimReport]:
        """Price a list of (partition, mapping) pairs through the active
        population backend when the pricing cache is live (else one
        step-major ``simulate`` each); counts every candidate.  Backend
        failures retry, then demote down the fallback chain; scripted
        :class:`~repro_torch.core.resilience.FaultPlan` faults inject
        here."""
        cands = list(candidates)
        self.n_evals += len(cands)
        if self.cache is not None:
            def attempt(backend):
                if self.fault_plan is not None:
                    self.fault_plan.check(backend)
                return simulate_population(self.net, self.xs, self.profile,
                                           cands, cache=self.cache,
                                           backend=backend)
            if self._chain is not None:
                reports = self._chain.run(attempt)
            else:
                reports = attempt(self.population_backend)
        else:
            reports = [simulate(self.net, self.xs, self.profile, p, m,
                                engine=self.engine, compute=self.compute)
                       for p, m in cands]
        if self.fault_plan is not None:
            reports = self.fault_plan.corrupt(reports)
        return reports


@dataclasses.dataclass
class OptStep:
    """One accepted/rejected move in the iteration log."""

    iteration: int
    assumption: Bottleneck
    move: str
    partition: Partition
    time: float
    energy: float
    max_synops: float
    accepted: bool
    note: str = ""


@dataclasses.dataclass
class OptimizationResult:
    partition: Partition
    mapping: Mapping
    report: SimReport
    history: list[OptStep]

    @property
    def trace(self) -> list[tuple[float, float]]:
        """(max_synops, time) path of accepted steps — the floorline trace."""
        return [(s.max_synops, s.time) for s in self.history if s.accepted]


def _bottleneck_layers(per_core: np.ndarray, part: Partition,
                       tie_tol: float = 0.05) -> list[int]:
    """All layers owning a core within ``tie_tol`` of the max load (the
    paper splits the argmax layer; a tied set is split together)."""
    core_layers = part.core_layer_ids()
    mx = float(np.max(per_core))
    hot = np.asarray(per_core) >= (1.0 - tie_tol) * mx
    return sorted({int(l) for l in core_layers[hot]})


def can_split(net: SimNetwork, part: Partition, layer: int,
              profile: ChipProfile) -> bool:
    """True iff the split move is legal for ``layer``: granularity, chip
    core budget, and per-core capacities all hold after the split."""
    if part.cores[layer] >= max_cores_for_layer(net, layer):
        return False
    if part.total_cores + 1 > profile.n_cores:
        return False
    return validate_partition(net, part.split(layer), profile)


def optimize_partitioning(
    net: SimNetwork,
    profile: ChipProfile,
    evaluate: Evaluator,
    *,
    max_iters: int = 64,
    time_improvement_tol: float = 0.01,
    energy_guard: bool = True,
    make_mapping: Callable[[Partition, ChipProfile], Mapping] = strided_mapping,
) -> OptimizationResult:
    """Run the §VI-B iterative backtracking procedure.  Moves are accepted
    only when time improves by more than ``time_improvement_tol``
    (relative) and, under ``energy_guard``, energy does not regress without
    a timing benefit.  Returns the best (partition, mapping, report) plus
    the full accept / backtrack history."""
    part = minimal_partition(net, profile)
    mapping = make_mapping(part, profile)
    best = evaluate(part, mapping)
    history: list[OptStep] = [OptStep(
        iteration=0, assumption=Bottleneck.MEMORY, move="init:minimal+strided",
        partition=part, time=best.time_per_step, energy=best.energy_per_step,
        max_synops=best.max_synops, accepted=True, note="baseline")]

    assumptions = [Bottleneck.MEMORY, Bottleneck.COMPUTE, Bottleneck.TRAFFIC]
    a_idx = 0
    stale = 0          # consecutive assumptions with no accepted move
    it = 0
    while it < max_iters and stale < len(assumptions):
        it += 1
        assumption = assumptions[a_idx]
        accepted = False
        if assumption in (Bottleneck.MEMORY, Bottleneck.COMPUTE):
            per_core = (best.per_core_synops
                        if assumption is Bottleneck.MEMORY
                        else best.per_core_acts).cpu().numpy()
            layers = [l for l in _bottleneck_layers(per_core, part)
                      if can_split(net, part, l, profile)]
            cand_part = part
            for l in layers:
                if validate_partition(net, cand_part.split(l), profile):
                    cand_part = cand_part.split(l)
            if cand_part.cores != part.cores:
                cand_map = make_mapping(cand_part, profile)
                rep = evaluate(cand_part, cand_map)
                time_gain = (best.time_per_step - rep.time_per_step) \
                    / max(best.time_per_step, 1e-30)
                energy_ok = (not energy_guard
                             or rep.energy_per_step <= best.energy_per_step
                             or time_gain > time_improvement_tol)
                if time_gain > time_improvement_tol and energy_ok:
                    part, mapping, best = cand_part, cand_map, rep
                    accepted = True
                history.append(OptStep(
                    iteration=it, assumption=assumption,
                    move=(f"split layers {layers} -> "
                          f"{[cand_part.cores[l] for l in layers]} cores"),
                    partition=cand_part, time=rep.time_per_step,
                    energy=rep.energy_per_step, max_synops=rep.max_synops,
                    accepted=accepted,
                    note="" if accepted else "backtracked (no benefit)"))
            else:
                history.append(OptStep(
                    iteration=it, assumption=assumption,
                    move="no split available", partition=part,
                    time=best.time_per_step, energy=best.energy_per_step,
                    max_synops=best.max_synops, accepted=False,
                    note="out of cores / granularity"))
        else:   # TRAFFIC: optimize the mapping only (synops intensity fixed)
            cand_map = _traffic_greedy_mapping(part, profile, best)
            if tuple(cand_map.phys) != tuple(mapping.phys):
                rep = evaluate(part, cand_map)
                gain = (best.time_per_step - rep.time_per_step) \
                    / max(best.time_per_step, 1e-30)
                if gain > time_improvement_tol:
                    mapping, best = cand_map, rep
                    accepted = True
                history.append(OptStep(
                    iteration=it, assumption=assumption,
                    move=f"remap ({cand_map.name})", partition=part,
                    time=rep.time_per_step, energy=rep.energy_per_step,
                    max_synops=rep.max_synops, accepted=accepted,
                    note="" if accepted else "backtracked"))
            else:
                history.append(OptStep(
                    iteration=it, assumption=assumption,
                    move="mapping unchanged", partition=part,
                    time=best.time_per_step, energy=best.energy_per_step,
                    max_synops=best.max_synops, accepted=False))
        if accepted:
            stale = 0            # keep working the same assumption
        else:
            stale += 1
            a_idx = (a_idx + 1) % len(assumptions)

    return OptimizationResult(partition=part, mapping=mapping, report=best,
                              history=history)


def _traffic_greedy_mapping(part: Partition, profile: ChipProfile,
                            report: SimReport) -> Mapping:
    """Traffic move (§VI-B): place the highest-output cores onto separate
    router paths — greedy round-robin over router tiles by descending
    message count (NumPy's argsort on the host copy, so ties break as in
    the reference)."""
    n = part.total_cores
    cpr = cores_per_router(profile)
    n_routers = n_router_tiles(profile)
    order = np.argsort(-report.per_core_msgs_out.cpu().numpy())
    slots_by_router = [[r * cpr + s for s in range(cpr)]
                       for r in range(n_routers)]
    phys = [0] * n
    r = 0
    for logical in order:
        placed = False
        for _ in range(n_routers):
            if slots_by_router[r]:
                phys[int(logical)] = slots_by_router[r].pop(0)
                r = (r + 1) % n_routers
                placed = True
                break
            r = (r + 1) % n_routers
        if not placed:
            raise RuntimeError("ran out of physical slots")
    return Mapping(tuple(phys), name="traffic_greedy")
