"""Vectorized evolutionary search over (partition, mapping) candidates
(PyTorch port).

The paper's stage-2 optimizer (§VI-B, :mod:`repro_torch.core.partitioner`)
walks one candidate at a time: split the bottleneck layer, re-price,
backtrack.  That is cheap but easily trapped.  A population-based search
holds many (partition, mapping) hypotheses at once, and the batched
engine's pricing split makes it affordable: one functional run + per-layer
counter cumsums (:func:`repro_torch.neuromorphic.timestep.
precompute_pricing`) price a whole generation, per candidate (``"numpy"``),
as one ``torch.func.vmap`` over padded structures (``"vmap"``) or as one
batched device program (``"device"``, the
:class:`~repro_torch.neuromorphic.timestep.DevicePopulationPricer`).

The genome representation is tensor-first: a generation lives in a
:class:`Population` — a ``(K, n_layers)`` core-count matrix plus a
``(K, n_slots)`` permutation matrix, numpy int32 on the host — and
mutation, tournament selection, nondomination ranking and elitist survival
operate on the stacked arrays (feasibility checks are lookups into a
precomputed :class:`MoveTables`).  :class:`Candidate` is the
per-individual view: ``cores`` per layer and ``perm``, a permutation of
all physical core slots whose first ``total_cores`` genes are the mapping.

The generation loop is (mu + lambda) elitist: tournament parent selection,
floorline-guided mutation (the parent's bottleneck stage picks the move —
memory/compute -> split the hot layer, traffic -> re-map or coagulate,
with an exploration probability of a uniformly random move), then survival
of the ``population_size`` best unique candidates ordered by
(nondomination rank, time, energy).  An epsilon-dominance archive
(:class:`EpsParetoArchive`) keeps the (time, energy) front across the run
(``SearchResult.front``); :func:`knee_point` names its balanced point.
Elitism plus floorline-informed seeding (the greedy walk's accepted moves
join the initial population) guarantee the search never returns a
candidate worse than its best seed.

This module is the JAX package's host ``"numpy"`` generation engine, with
the same numpy RNG draws in the same order: under the same seed and the
same prices it visits the same genomes every generation.  The
``"device"`` and ``"sharded"`` engines, which draw from the JAX package's
counter-based (threefry) stream, live in :mod:`repro_torch.core.
device_search`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.partitioner import (Evaluator, OptimizationResult,
                                          optimize_partitioning)
from repro_torch.core.resilience import (FaultPlan, SearchCheckpointer,
                                         decode_bytes_set, encode_bytes_set,
                                         finite_mean, quarantine_rows,
                                         rng_from_state, rng_state,
                                         validate_resume_meta)
from repro_torch.neuromorphic.network import SimNetwork
from repro_torch.neuromorphic.noc import (Mapping, ordered_mapping,
                                          random_mapping, strided_mapping)
from repro_torch.neuromorphic.partition import (Partition, layer_fits,
                                                max_cores_for_layer,
                                                minimal_partition)
from repro_torch.neuromorphic.platform import ChipProfile
from repro_torch.neuromorphic.timestep import SimReport, _host

_STAGES = ("memory", "compute", "traffic")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """Fixed-shape genome: per-layer core counts + a permutation of every
    physical core slot (only the first ``total_cores`` genes are expressed
    as the mapping)."""

    cores: tuple[int, ...]
    perm: tuple[int, ...]

    @property
    def n_logical(self) -> int:
        return int(sum(self.cores))

    def partition(self) -> Partition:
        return Partition(self.cores)

    def mapping(self) -> Mapping:
        return Mapping(self.perm[:self.n_logical], name="evolved")


def encode(part: Partition, mapping: Mapping,
           n_cores_phys: int) -> Candidate:
    """(Partition, Mapping) -> fixed-shape genome.  The mapping's slots
    become the leading genes; unused physical slots follow in ascending
    order, so ``decode(encode(p, m))`` reproduces the partition and the
    ``phys`` placement exactly (the decoded mapping is named "evolved")."""
    used = tuple(int(p) for p in mapping.phys)
    taken = set(used)
    rest = tuple(s for s in range(n_cores_phys) if s not in taken)
    return Candidate(tuple(int(c) for c in part.cores), used + rest)


def decode(cand: Candidate) -> tuple[Partition, Mapping]:
    return cand.partition(), cand.mapping()


# ------------------------------------------------------------- population

@dataclasses.dataclass
class Population:
    """Tensor-first genome bank: row k of ``cores``/``perm`` is candidate
    k.  :meth:`candidate` / :meth:`candidates` materialize per-individual
    :class:`Candidate` views; :meth:`pairs` decodes the bank into the
    ``(Partition, Mapping)`` pairs the pricing backends consume."""

    cores: np.ndarray   # (K, n_layers) int32
    perm: np.ndarray    # (K, n_slots) int32

    def __post_init__(self):
        self.cores = np.asarray(self.cores, np.int32)
        self.perm = np.asarray(self.perm, np.int32)

    def __len__(self) -> int:
        return int(self.cores.shape[0])

    @property
    def n_logical(self) -> np.ndarray:
        """(K,) expressed-gene counts."""
        return self.cores.sum(axis=1)

    @staticmethod
    def from_candidates(cands: list[Candidate]) -> "Population":
        return Population(np.asarray([c.cores for c in cands], np.int32),
                          np.asarray([c.perm for c in cands], np.int32))

    def candidate(self, k: int) -> Candidate:
        return Candidate(tuple(int(x) for x in self.cores[k]),
                         tuple(int(x) for x in self.perm[k]))

    def candidates(self) -> list[Candidate]:
        return [self.candidate(k) for k in range(len(self))]

    def pairs(self) -> list[tuple[Partition, Mapping]]:
        out = []
        n_log = self.n_logical
        for k in range(len(self)):
            out.append((Partition(tuple(int(x) for x in self.cores[k])),
                        Mapping(tuple(int(x) for x in
                                      self.perm[k, :n_log[k]]),
                                name="evolved")))
        return out

    @staticmethod
    def row_key(cores_row: np.ndarray, perm_row: np.ndarray) -> bytes:
        """Expressed-genes dedup key for one genome row: two genomes that
        differ only in the unexpressed permutation tail decode to the same
        (partition, mapping) and must not be priced twice or hold two
        elitist slots.  The single source of the key format."""
        return (cores_row.tobytes()
                + perm_row[:int(cores_row.sum())].tobytes())

    def phenotype(self, k: int) -> bytes:
        return self.row_key(self.cores[k], self.perm[k])

    def take(self, idx) -> "Population":
        return Population(self.cores[idx], self.perm[idx])

    @staticmethod
    def concatenate(a: "Population", b: "Population") -> "Population":
        return Population(np.concatenate([a.cores, b.cores]),
                          np.concatenate([a.perm, b.perm]))


def encode_population(cands: list[Candidate]) -> tuple[np.ndarray, np.ndarray]:
    """Population -> ((K, n_layers) core counts, (K, n_cores_phys) perms)."""
    pop = Population.from_candidates(cands)
    return pop.cores, pop.perm


def decode_population(cores: np.ndarray, perm: np.ndarray) -> list[Candidate]:
    return Population(cores, perm).candidates()


# ------------------------------------------------------------ move tables

@dataclasses.dataclass(frozen=True)
class MoveTables:
    """Precomputed per-layer feasibility: ``feasible[l, c]`` is True iff
    assigning ``c`` cores to layer ``l`` satisfies the chip's granularity
    and per-core capacity limits.  Genome-level moves and row validation
    become table lookups."""

    feasible: np.ndarray    # (n_layers, n_cores_phys + 2) bool
    n_cores_phys: int

    def valid_rows(self, cores: np.ndarray) -> np.ndarray:
        """(K,) validity of each core-count row (the vectorized
        ``validate_partition``)."""
        cores = np.asarray(cores)
        c = np.clip(cores, 0, self.feasible.shape[1] - 1)
        ok = self.feasible[np.arange(cores.shape[1])[None, :], c]
        return ok.all(axis=1) & (cores.sum(axis=1) <= self.n_cores_phys)


def move_tables(net: SimNetwork, profile: ChipProfile) -> MoveTables:
    feas = np.zeros((len(net.layers), profile.n_cores + 2), bool)
    for l, layer in enumerate(net.layers):
        cap = min(max_cores_for_layer(net, l), profile.n_cores)
        if not profile.allow_partitioning:
            cap = 1
        for c in range(1, cap + 1):
            feas[l, c] = layer_fits(layer, c, profile)
    return MoveTables(feasible=feas, n_cores_phys=profile.n_cores)


# ---------------------------------------------------------------- fronts

def pareto_ranks(times: np.ndarray, energies: np.ndarray,
                 n_keep: int | None = None) -> np.ndarray:
    """(K,) nondomination rank per candidate (0 = Pareto-optimal) under
    (time, energy) minimization.  The lexicographic (time, energy) minimum
    is always rank 0.  ``n_keep`` caps the front peeling for survival
    selection: peeling stops once at least ``n_keep`` rows are ranked, and
    every unpeeled row gets the sentinel rank ``K``."""
    t = np.asarray(times, np.float64)
    e = np.asarray(energies, np.float64)
    n = t.size
    cap = n if n_keep is None else min(int(n_keep), n)
    # dominated_by[i, j]: candidate j dominates candidate i
    dominated_by = ((t[None, :] <= t[:, None]) & (e[None, :] <= e[:, None])
                    & ((t[None, :] < t[:, None]) | (e[None, :] < e[:, None])))
    ranks = np.full(n, n, int)          # sentinel: never peeled
    remaining = np.ones(n, bool)
    r = 0
    peeled = 0
    while remaining.any() and peeled < cap:
        dom = (dominated_by & remaining[None, :]).sum(axis=1)
        frontier = remaining & (dom == 0)
        ranks[frontier] = r
        peeled += int(frontier.sum())
        remaining &= ~frontier
        r += 1
    return ranks


def knee_point(times, energies) -> int:
    """Index of the knee of a (time, energy) front: the point closest (in
    normalized objective space) to the ideal corner."""
    t = np.asarray(times, np.float64)
    e = np.asarray(energies, np.float64)
    tn = (t - t.min()) / max(np.ptp(t), 1e-30)
    en = (e - e.min()) / max(np.ptp(e), 1e-30)
    return int(np.argmin(np.hypot(tn, en)))


class EpsParetoArchive:
    """Epsilon-dominance (time, energy) Pareto archive (Laumanns-style).

    A point enters iff no member multiplicatively epsilon-dominates it
    (``q.time <= p.time*(1+eps)`` and ``q.energy <= p.energy*(1+eps)``);
    on entry, members it plainly dominates are evicted.  The epsilon grid
    bounds the archive's size, so it can absorb every candidate the search
    ever prices."""

    def __init__(self, eps: float = 0.01):
        self.eps = float(eps)
        self._items: list[dict] = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, time: float, energy: float, cores: np.ndarray,
            perm: np.ndarray, report: SimReport) -> bool:
        if not (np.isfinite(time) and np.isfinite(energy)):
            # a NaN point would pass both tests below and stay forever
            return False
        one_eps = 1.0 + self.eps
        for it in self._items:
            if it["time"] <= time * one_eps and \
                    it["energy"] <= energy * one_eps:
                return False
        self._items = [it for it in self._items
                       if not (time <= it["time"] and energy <= it["energy"])]
        self._items.append(dict(time=float(time), energy=float(energy),
                                cores=np.array(cores, np.int32),
                                perm=np.array(perm, np.int32),
                                report=report))
        return True

    def update(self, pop: Population, times: np.ndarray,
               energies: np.ndarray, reports: list[SimReport]) -> None:
        self.update_batch(times, energies, pop.cores, pop.perm,
                          reports=reports)

    def update_batch(self, times, energies, cores, perm, *,
                     reports: list | None = None) -> int:
        """One vectorized per-generation update, exactly equivalent to
        sequential :meth:`add` calls in batch order: one stacked
        epsilon-domination test against the pre-update members culls the
        batch, and only the survivors go through :meth:`add` (a point that
        evicts a member dominates it, hence blocks at least what the
        member blocked, so the prefilter stays exact).  Returns the number
        of points admitted."""
        times = np.asarray(times, np.float64)
        energies = np.asarray(energies, np.float64)
        K = times.shape[0]
        if K == 0:
            return 0
        finite = np.isfinite(times) & np.isfinite(energies)
        if self._items:
            one_eps = 1.0 + self.eps
            at = np.asarray([it["time"] for it in self._items])
            ae = np.asarray([it["energy"] for it in self._items])
            blocked = ((at[None, :] <= times[:, None] * one_eps)
                       & (ae[None, :] <= energies[:, None] * one_eps)
                       ).any(axis=1)
        else:
            blocked = np.zeros(K, bool)
        blocked |= ~finite             # non-finite points never enter
        added = 0
        for k in np.flatnonzero(~blocked):
            added += self.add(float(times[k]), float(energies[k]),
                              cores[k], perm[k],
                              reports[k] if reports is not None else None)
        return added

    def front(self) -> tuple[list[Candidate], list[SimReport]]:
        """Archive contents sorted by time: (candidates, reports)."""
        items = sorted(self._items, key=lambda it: (it["time"], it["energy"]))
        cands = [Candidate(tuple(int(x) for x in it["cores"]),
                           tuple(int(x) for x in it["perm"]))
                 for it in items]
        return cands, [it["report"] for it in items]

    def state_arrays(self, n_layers: int, n_slots: int) -> dict:
        """Archive contents as stacked arrays in insertion order — the
        checkpoint interchange form.  Reports are not serialized; a
        resumed search re-prices the front once at the end (uncharged)."""
        items = self._items
        return dict(
            arch_times=np.asarray([it["time"] for it in items], np.float64),
            arch_energies=np.asarray([it["energy"] for it in items],
                                     np.float64),
            arch_cores=(np.stack([it["cores"] for it in items])
                        if items else np.zeros((0, n_layers), np.int32)),
            arch_perm=(np.stack([it["perm"] for it in items])
                       if items else np.zeros((0, n_slots), np.int32)))

    def load_state(self, arrays: dict) -> None:
        """Rebuild the archive from :meth:`state_arrays` output, insertion
        order preserved, so later admissions and evictions replay
        identically to the run that wrote the snapshot."""
        self._items = [
            dict(time=float(t), energy=float(e),
                 cores=np.asarray(c, np.int32),
                 perm=np.asarray(p, np.int32), report=None)
            for t, e, c, p in zip(arrays["arch_times"],
                                  arrays["arch_energies"],
                                  arrays["arch_cores"],
                                  arrays["arch_perm"])]


@dataclasses.dataclass
class GenStats:
    """Per-generation progress record."""

    generation: int
    best_time: float
    best_energy: float
    mean_time: float        # over finite survivors
    n_evals: int            # cumulative evaluations after this generation
    front_size: int = 0     # epsilon-archive size after this generation
    n_quarantined: int = 0  # non-finite pricing rows screened this gen


@dataclasses.dataclass
class SearchResult:
    candidate: Candidate
    partition: Partition
    mapping: Mapping
    report: SimReport
    history: list[GenStats]
    n_evals: int
    seed_best_time: float   # best initial-population time (never-worse bound)
    #: epsilon-nondominated (time, energy) candidates, sorted by time
    front: list[Candidate] = dataclasses.field(default_factory=list)
    front_reports: list[SimReport] = dataclasses.field(default_factory=list)
    #: backend demotions logged during this run (``resilience.Demotion``
    #: records from the evaluator's fallback chain); empty on a
    #: fault-free run
    demotions: list = dataclasses.field(default_factory=list)
    #: the device engines' instrumentation (``device_search.
    #: SearchTelemetry.summary()``: peel iterations and host syncs per
    #: generation, time per stage); empty for the numpy engine
    telemetry: dict = dataclasses.field(default_factory=dict)

    def knee(self) -> tuple[Candidate, SimReport] | None:
        """The front's knee point (None when the front is empty)."""
        if not self.front:
            return None
        i = knee_point([r.time_per_step for r in self.front_reports],
                       [r.energy_per_step for r in self.front_reports])
        return self.front[i], self.front_reports[i]


def _evaluate(evaluator: Evaluator, pop: Population) -> list[SimReport]:
    pairs = pop.pairs()
    ep = getattr(evaluator, "evaluate_population", None)
    if ep is not None:
        return ep(pairs)
    return [evaluator(p, m) for p, m in pairs]


def _reprice_uncharged(evaluator: Evaluator,
                       pop: Population) -> list[SimReport]:
    """Re-price rows for report materialization (resume bootstrap, front
    reports) without charging the evaluation ledger or consuming the
    evaluator's fault-plan schedule."""
    n0 = getattr(evaluator, "n_evals", None)
    plan = getattr(evaluator, "fault_plan", None)
    if plan is not None:
        evaluator.fault_plan = None
    try:
        reports = _evaluate(evaluator, pop)
    finally:
        if plan is not None:
            evaluator.fault_plan = plan
    if n0 is not None:
        evaluator.n_evals = n0
    return reports


def _validate_search_args(net: SimNetwork, profile: ChipProfile, *,
                          population_size: int, generations: int,
                          seed_candidates) -> None:
    """Early, actionable argument validation."""
    if population_size < 2:
        raise ValueError(
            f"population_size must be >= 2, got {population_size}: "
            "tournament selection and (mu + lambda) survival need at "
            "least two candidates")
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
    n_layers, n_slots = len(net.layers), int(profile.n_cores)
    for i, c in enumerate(seed_candidates or ()):
        if len(c.cores) != n_layers or len(c.perm) != n_slots:
            raise ValueError(
                f"seed candidate {i} has genome shape (cores={len(c.cores)},"
                f" perm={len(c.perm)}) but this (network, profile) needs "
                f"(cores={n_layers}, perm={n_slots})")


# ------------------------------------------------------------------ seeding

def seeded_population(net: SimNetwork, profile: ChipProfile, *, size: int,
                      rng: np.random.Generator,
                      greedy: OptimizationResult | None = None,
                      ) -> list[Candidate]:
    """Floorline-informed initial population.

    Seeds, in priority order (truncation keeps the head): the greedy
    optimizer's final (partition, mapping) and its accepted intermediate
    partitions under a strided mapping, the minimal partition under
    strided / ordered mappings, then random split-walks with random
    mappings up to ``size``.
    """
    P = profile.n_cores
    tables = move_tables(net, profile)
    seeds: list[Candidate] = []
    if greedy is not None:
        seeds.append(encode(greedy.partition, greedy.mapping, P))
        for step in greedy.history:
            if step.accepted:
                seeds.append(encode(step.partition,
                                    strided_mapping(step.partition, profile),
                                    P))
    p0 = minimal_partition(net, profile)
    seeds.append(encode(p0, strided_mapping(p0, profile), P))
    seeds.append(encode(p0, ordered_mapping(p0, profile), P))

    unique: list[Candidate] = []
    for c in seeds:
        if c not in unique:
            unique.append(c)
    unique = unique[:size]

    n_layers = len(net.layers)
    guard = 0
    while len(unique) < size and guard < 50 * size:
        guard += 1
        cores = np.asarray(p0.cores, np.int32).copy()
        for _ in range(int(rng.integers(0, n_layers * 2 + 1))):
            l = int(rng.integers(n_layers))
            if tables.feasible[l, cores[l] + 1] \
                    and cores.sum() + 1 <= P:
                cores[l] += 1
        part = Partition(tuple(int(x) for x in cores))
        c = encode(part, random_mapping(part, profile, rng), P)
        if c not in unique:
            unique.append(c)
    return unique


# ---------------------------------------------------------------- mutations

def _swap_rows(cores_row: np.ndarray, perm_row: np.ndarray,
               rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Swap one expressed mapping gene with any other gene — re-places a
    logical core onto a different physical slot (possibly one currently
    unused).  Always yields a valid candidate."""
    perm = perm_row.copy()
    n = int(cores_row.sum())
    i = int(rng.integers(0, max(n, 1)))
    j = int(rng.integers(0, perm.shape[0]))
    if i == j:
        j = (j + 1) % perm.shape[0]
    perm[i], perm[j] = perm[j], perm[i]
    return cores_row, perm


def _hot_layer(cores_row: np.ndarray, per_core) -> int:
    """Layer owning the max-loaded core (the M0 bottleneck unit), from the
    stacked genome row and a report's per-core loads (a tensor anywhere;
    the argmax runs on the host copy, so ties break as numpy breaks
    them)."""
    core_layers = np.repeat(np.arange(cores_row.shape[0]), cores_row)
    return int(core_layers[int(np.argmax(_host(per_core)))])


def _split_rows(cores_row: np.ndarray, perm_row: np.ndarray, hot: int,
                rng: np.random.Generator, tables: MoveTables,
                ) -> tuple[np.ndarray, np.ndarray] | None:
    """Split the bottleneck layer (or, failing that, a random splittable
    one) — the memory/compute assumption's move."""
    if cores_row.sum() + 1 > tables.n_cores_phys:
        return None
    for l in [hot] + [int(x) for x in rng.permutation(cores_row.shape[0])]:
        if tables.feasible[l, cores_row[l] + 1]:
            cores = cores_row.copy()
            cores[l] += 1
            return cores, perm_row
    return None


def _merge_rows(cores_row: np.ndarray, perm_row: np.ndarray,
                rng: np.random.Generator, tables: MoveTables,
                ) -> tuple[np.ndarray, np.ndarray] | None:
    """Coagulate a multi-core layer (§VI-A move (c): fewer cores -> less
    message duplication and active power)."""
    for l in rng.permutation(cores_row.shape[0]):
        l = int(l)
        if cores_row[l] > 1 and tables.feasible[l, cores_row[l] - 1]:
            cores = cores_row.copy()
            cores[l] -= 1
            return cores, perm_row
    return None


def _mutate_rows(cores_row: np.ndarray, perm_row: np.ndarray,
                 report: SimReport, rng: np.random.Generator,
                 tables: MoveTables, *, explore_prob: float,
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Floorline-guided mutation on one genome row: the parent's bottleneck
    stage selects the move family (§VI-A a/b/c), with probability
    ``explore_prob`` of a uniformly random stage instead.  Falls back
    across families until a valid, different row pair emerges (a gene swap
    always is)."""
    stage = report.bottleneck_stage
    if stage not in _STAGES or rng.random() < explore_prob:
        stage = _STAGES[int(rng.integers(len(_STAGES)))]
    for _ in range(4):
        if stage == "memory":
            child = _split_rows(cores_row, perm_row,
                                _hot_layer(cores_row, report.per_core_synops),
                                rng, tables)
        elif stage == "compute":
            child = _split_rows(cores_row, perm_row,
                                _hot_layer(cores_row, report.per_core_acts),
                                rng, tables)
        elif rng.random() < 0.5:
            child = _merge_rows(cores_row, perm_row, rng, tables)
        else:
            child = _swap_rows(cores_row, perm_row, rng)
        if child is not None:
            c, p = child
            changed = (not np.array_equal(c, cores_row)
                       or not np.array_equal(p, perm_row))
            if changed and tables.valid_rows(c[None, :])[0]:
                return c, p
        stage = _STAGES[int(rng.integers(len(_STAGES)))]
    return _swap_rows(cores_row, perm_row, rng)


def mutate(cand: Candidate, report: SimReport, net: SimNetwork,
           profile: ChipProfile, rng: np.random.Generator, *,
           explore_prob: float = 0.25,
           tables: MoveTables | None = None) -> Candidate:
    """Candidate-level wrapper over the row mutation (the search loop
    mutates :class:`Population` rows directly)."""
    tables = tables or move_tables(net, profile)
    cores, perm = _mutate_rows(np.asarray(cand.cores, np.int32),
                               np.asarray(cand.perm, np.int32),
                               report, rng, tables,
                               explore_prob=explore_prob)
    return Candidate(tuple(int(x) for x in cores),
                     tuple(int(x) for x in perm))


# ------------------------------------------------------------------- search

def evolutionary_search(
    net: SimNetwork,
    profile: ChipProfile,
    evaluator: Evaluator,
    *,
    population_size: int = 24,
    generations: int = 16,
    tournament_k: int = 3,
    explore_prob: float = 0.25,
    seed: int = 0,
    max_evaluations: int | None = None,
    seed_candidates: list[Candidate] | None = None,
    greedy: OptimizationResult | None = None,
    pareto_eps: float = 0.01,
    engine: str = "numpy",
    n_islands: int | None = None,
    migrate_every: int = 5,
    n_migrants: int | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 3,
    resume: bool = False,
    fault_plan: FaultPlan | None = None,
    reference: bool = False,
    retry=None,
    group=None,
) -> SearchResult:
    """Run the (mu + lambda) evolutionary mapping search, tensor-first.

    ``evaluator`` is any :data:`~repro_torch.core.partitioner.Evaluator`;
    when it exposes ``evaluate_population`` (:class:`~repro_torch.core.
    partitioner.SimEvaluator` does) each generation is priced in one call,
    through the evaluator's population backend (on the card, the batched
    ``"device"`` pricer).  ``max_evaluations`` caps total candidate
    pricings; ``greedy`` feeds the accepted §VI-B moves into the initial
    population; ``pareto_eps`` sets the epsilon grid of the (time, energy)
    archive returned as ``SearchResult.front``.  Deterministic for a fixed
    ``seed`` and evaluator.

    ``engine`` selects the generation loop: ``"numpy"``, this host loop,
    or ``"device"``, the whole generation (selection, mutation, pricing,
    ranking, survival) as one array program on the device of the
    evaluator's pricing cache (:mod:`repro_torch.core.device_search`; it
    needs a :class:`~repro_torch.core.partitioner.SimEvaluator`-like
    evaluator and follows the JAX package's threefry key contract, so the
    two engines are deterministic per seed but draw different streams).
    ``"sharded"`` runs the device engine as an island model on one card:
    ``n_islands`` equal islands (default 1, which reproduces ``"device"``
    bit for bit), ``n_migrants`` elites (default an eighth of an island)
    moving one island on every ``migrate_every`` generations.  For these
    two engines ``reference=True`` runs the host mirror, and ``retry``
    (a :class:`~repro_torch.core.resilience.RetryPolicy`) sets the
    retries before a failing engine demotes to it; the island keywords
    are only meaningful for ``"sharded"``.  ``group`` (``"sharded"``
    only): spread the islands over the ranks of a ``torch.distributed``
    process group.

    Fault tolerance: with ``checkpoint_dir`` the search writes an atomic,
    self-contained snapshot every ``checkpoint_every`` generations
    (``checkpoint_keep`` newest retained); ``resume=True`` continues from
    the newest one bit-identically to the uninterrupted run — the host RNG
    state, the phenotype dedup set, the survivor fitness and the epsilon
    archive all travel in the snapshot, in the JAX package's layout.
    Non-finite pricing rows are quarantined with sentinel-worst fitness
    every generation.  ``fault_plan`` scripts deterministic faults
    (injected backend failures, NaN rows, a simulated kill) for testing.
    """
    _validate_search_args(net, profile, population_size=population_size,
                          generations=generations,
                          seed_candidates=seed_candidates)
    if engine in ("device", "sharded"):
        from repro_torch.core import device_search
        kw = dict(population_size=population_size, generations=generations,
                  tournament_k=tournament_k, explore_prob=explore_prob,
                  seed=seed, max_evaluations=max_evaluations,
                  seed_candidates=seed_candidates, greedy=greedy,
                  pareto_eps=pareto_eps, reference=reference,
                  checkpoint_dir=checkpoint_dir,
                  checkpoint_every=checkpoint_every,
                  checkpoint_keep=checkpoint_keep, resume=resume,
                  fault_plan=fault_plan, retry=retry)
        if engine == "device":
            if group is not None:
                raise ValueError("group= spreads the 'sharded' engine's "
                                 "islands")
            return device_search.evolutionary_search_device(
                net, profile, evaluator, **kw)
        if group is not None:
            kw["group"] = group
        return device_search.evolutionary_search_sharded(
            net, profile, evaluator, n_islands=n_islands,
            migrate_every=migrate_every, n_migrants=n_migrants, **kw)
    if group is not None:
        raise ValueError("group= spreads the 'sharded' engine's islands")
    if engine != "numpy":
        raise ValueError(f"unknown search engine {engine!r}")
    if reference or retry is not None:
        raise ValueError("reference= and retry= belong to the 'device' and "
                         "'sharded' engines; the numpy engine's retries are "
                         "its evaluator's")
    ckpt = (SearchCheckpointer(checkpoint_dir, every=checkpoint_every,
                               keep=checkpoint_keep)
            if checkpoint_dir else None)
    restored = ckpt.restore() if (ckpt is not None and resume) else None
    if fault_plan is not None:
        setattr(evaluator, "fault_plan", fault_plan)
    n_demote0 = len(getattr(evaluator, "demotions", ()))
    tables = move_tables(net, profile)
    archive = EpsParetoArchive(pareto_eps)
    n_layers = len(net.layers)
    n_slots = profile.n_cores

    if restored is not None:
        arrays, gen0, meta = restored
        validate_resume_meta(meta, engine="numpy",
                             checkpoint_dir=checkpoint_dir)
        rng = rng_from_state(meta["rng_state"])
        pop = Population(arrays["cores"], arrays["perm"])
        times = np.asarray(arrays["times"], np.float64)
        energies = np.asarray(arrays["energies"], np.float64)
        # survivor reports (bottleneck stages / hot layers feed mutation)
        # are rebuilt deterministically; the checkpointed times/energies
        # stay authoritative
        reports = _reprice_uncharged(evaluator, pop)
        tried = decode_bytes_set(arrays["tried_buf"], arrays["tried_lens"])
        archive.load_state(arrays)
        history = [GenStats(**h) for h in meta["history"]]
        evals_used = int(meta["evals_used"])
        seed_best_time = float(meta["seed_best_time"])
        start_gen = gen0 + 1
    else:
        rng = np.random.default_rng(seed)
        cands = list(seed_candidates if seed_candidates is not None else
                     seeded_population(net, profile, size=population_size,
                                       rng=rng, greedy=greedy))
        if not cands:
            raise ValueError("empty initial population")
        if max_evaluations is not None:
            cands = cands[:max(1, max_evaluations)]
        pop = Population.from_candidates(cands)
        reports = _evaluate(evaluator, pop)
        evals_used = len(pop)
        times, energies, bad0 = quarantine_rows(
            np, np.asarray([r.time_per_step for r in reports], np.float64),
            np.asarray([r.energy_per_step for r in reports], np.float64))
        seed_best_time = float(times.min())
        start_gen = 1
        # every phenotype ever priced, across generations (restored from
        # the snapshot on resume, not from the survivors)
        tried = {pop.phenotype(k) for k in range(len(pop))}

    def _order(t, e):
        """(rank, time, energy) survival order — np.lexsort is keyed last
        first."""
        return np.lexsort((e, t, pareto_ranks(t, e)))

    def _snapshot(gen: int) -> None:
        arrays = dict(cores=pop.cores, perm=pop.perm, times=times,
                      energies=energies)
        arrays["tried_buf"], arrays["tried_lens"] = encode_bytes_set(tried)
        arrays.update(archive.state_arrays(n_layers, n_slots))
        meta = dict(engine="numpy", rng_state=rng_state(rng),
                    evals_used=int(evals_used),
                    seed_best_time=float(seed_best_time),
                    history=[dataclasses.asdict(g) for g in history])
        ckpt.save(gen, arrays, meta)

    if restored is None:
        order = _order(times, energies)
        pop = pop.take(order)
        reports = [reports[k] for k in order]
        times, energies = times[order], energies[order]
        archive.update(pop, times, energies, reports)

        history = [GenStats(generation=0,
                            best_time=float(times[0]),
                            best_energy=float(energies[0]),
                            mean_time=float(finite_mean(np, times)),
                            n_evals=evals_used,
                            front_size=len(archive),
                            n_quarantined=int(bad0.sum()))]
        if ckpt is not None:
            _snapshot(0)
        if fault_plan is not None:
            fault_plan.after_generation(0)

    for gen in range(start_gen, generations + 1):
        n_off = population_size
        if max_evaluations is not None:
            n_off = min(n_off, max_evaluations - evals_used)
        if n_off <= 0:
            break
        # vectorized tournament: the population is (rank, time, energy)-
        # sorted, so fitness order == index order and a tournament is a
        # row-min over the stacked draw matrix
        draws = rng.integers(0, len(pop),
                             size=(n_off, max(1, tournament_k)))
        parents = draws.min(axis=1)
        off_cores = np.empty((n_off, n_layers), np.int32)
        off_perm = np.empty((n_off, n_slots), np.int32)
        for j, i in enumerate(parents):
            i = int(i)
            c, p = _mutate_rows(pop.cores[i], pop.perm[i], reports[i], rng,
                                tables, explore_prob=explore_prob)
            for _ in range(4):          # don't waste budget on repeats
                if Population.row_key(c, p) not in tried:
                    break
                c, p = _mutate_rows(pop.cores[i], pop.perm[i], reports[i],
                                    rng, tables, explore_prob=explore_prob)
            tried.add(Population.row_key(c, p))
            off_cores[j], off_perm[j] = c, p
        off_pop = Population(off_cores, off_perm)
        off_reports = _evaluate(evaluator, off_pop)
        evals_used += len(off_pop)
        off_times, off_energies, off_bad = quarantine_rows(
            np,
            np.asarray([r.time_per_step for r in off_reports], np.float64),
            np.asarray([r.energy_per_step for r in off_reports], np.float64))
        archive.update(off_pop, off_times, off_energies, off_reports)

        # (mu + lambda) elitist survival over unique candidates
        all_pop = Population.concatenate(pop, off_pop)
        all_r = reports + off_reports
        all_t = np.concatenate([times, off_times])
        all_e = np.concatenate([energies, off_energies])
        order = _order(all_t, all_e)
        keep, seen = [], set()
        for k in order:
            key = all_pop.phenotype(int(k))
            if key in seen:
                continue
            seen.add(key)
            keep.append(int(k))
            if len(keep) == population_size:
                break
        pop = all_pop.take(keep)
        reports = [all_r[k] for k in keep]
        times, energies = all_t[keep], all_e[keep]
        history.append(GenStats(
            generation=gen,
            best_time=float(times[0]),
            best_energy=float(energies[0]),
            mean_time=float(finite_mean(np, times)),
            n_evals=evals_used,
            front_size=len(archive),
            n_quarantined=int(off_bad.sum())))
        if ckpt is not None and ckpt.due(gen, generations):
            _snapshot(gen)
        if fault_plan is not None:
            fault_plan.after_generation(gen)

    best, best_r = pop.candidate(0), reports[0]
    front, front_reports = archive.front()
    if front and any(r is None for r in front_reports):
        # restored archive items carry no report; materialize them once,
        # uncharged (front() is (time, energy)-sorted, as is the repricing)
        front_reports = _reprice_uncharged(
            evaluator, Population.from_candidates(front))
    return SearchResult(candidate=best, partition=best.partition(),
                        mapping=best.mapping(), report=best_r,
                        history=history, n_evals=evals_used,
                        seed_best_time=seed_best_time,
                        front=front, front_reports=front_reports,
                        demotions=list(
                            getattr(evaluator, "demotions", ()))[n_demote0:])


def greedy_then_evolve(net: SimNetwork, profile: ChipProfile,
                       evaluator: Evaluator, *,
                       max_evaluations: int | None = None,
                       **kw) -> tuple[OptimizationResult, SearchResult]:
    """The two optimizers end-to-end on one evaluator: run the §VI-B greedy
    walk, then the evolutionary search seeded from its accepted moves.  With
    elitism the search result is never worse than the greedy one."""
    greedy = optimize_partitioning(net, profile, evaluator)
    evo = evolutionary_search(net, profile, evaluator, greedy=greedy,
                              max_evaluations=max_evaluations, **kw)
    return greedy, evo
