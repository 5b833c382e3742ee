"""Device-resident evolutionary generation engines (PyTorch port):
``engine="device"`` and the island-model ``engine="sharded"``.

The host ``"numpy"`` engine of :mod:`repro_torch.core.search` prices each
generation in one batch, but its generation loop (tournament draws, the
per-offspring mutation chain, phenotype dedup, survival) is per-offspring
Python on the host.  Here the whole generation is one array program over
the stacked ``(K, n_layers)`` core-count and ``(K, n_slots)`` permutation
tensors on the pricing cache's device:

1. **tournament selection**: a row-min over the draw matrix (survivors are
   kept (rank, time, energy)-sorted, so fitness order is index order);
2. **table-gated mutation** (:func:`mutate_rows_array`): the bottleneck
   stage picks split / merge / swap per offspring, feasibility is a gather
   into the :class:`~repro_torch.core.search.MoveTables` matrix, and the
   fallback is a masked cascade (split, then merge, then swap);
3. **pricing**: the cache's :class:`~repro_torch.neuromorphic.timestep.
   DevicePopulationPricer` over the offspring rows;
4. **survival** (:func:`pareto_ranks_array`, :func:`survival_order_array`):
   nondomination ranks, the ``(rank, time, energy, index)`` order and a
   sort-based phenotype dedup, keeping the ``population_size`` best unique
   rows.

Survivor state stays on the device between generations.  The host reads
one stats-and-offspring transfer per generation (the offspring feed the
epsilon-Pareto archive) and one flag per peeled front: the peel loop's
stop depends on the data, so each front costs a host sync on the card
(:class:`SearchTelemetry` counts them).

**The PRNG-key contract** is the JAX package's, drawn bit for bit by
:mod:`repro_torch.core.prng`: generation ``g`` consumes exactly the draws
of :func:`generation_draws` under ``fold_in(PRNGKey(seed), g)``, and island
``i`` of the sharded engine those under ``fold_in(key, g * n_islands +
i)`` (:func:`island_keys`), which for one island is the device engine's
stream.  Under the same seed and prices the port therefore visits the JAX
package's genomes in every generation.  The host mirror
(``reference=True``, :class:`_NumpyMirror`) runs the same program on CPU
tensors with the bit-exact ``"numpy"`` population backend.

**Islands.**  The sharded engine keeps the population in
island-block order (global row ``i * local_pop + r`` is island ``i``'s row
``r``) and runs every island's generation as one program with a leading
island axis: mutation and pricing are row-wise, ranking and survival work
per island along that axis.  Every ``migrate_every`` generations each
island's top ``n_migrants`` rows replace the next island's (island ``i``
takes island ``i - 1``'s), a rotation of the block axis in place of the
JAX package's ``ppermute`` ring.  With one island it is exactly the
device engine.  :class:`_ShardedHostMirror` replays it island by island
on the host.  With a process ``group`` of R ranks (the JAX package's
``shard_map`` over its island mesh) each rank holds ``n_islands / R``
consecutive islands in the same program: migration is the rotation
within the rank plus a :func:`~repro_torch.distributed.collectives.
ring_shift` of the edge island's elites between ranks, the generation's
stats gather the leaders and sum the finite means' sums and counts, each
generation's offspring are gathered for the archive, and snapshots are
gathered to rank 0 in the one-program layout, so a run resumes at another
rank count.  Draws stay :func:`island_keys` of the global island index.

Two deliberate deviations from the numpy engine, as in the JAX package: no
``tried``-set resampling of duplicate offspring (duplicates are removed at
survival), and a fixed population size (when fewer unique rows exist, the
best duplicates fill the batch).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.core.resilience import (Demotion, FaultPlan, RetryPolicy,
                                         SearchCheckpointer, finite_mean,
                                         quarantine_rows,
                                         validate_resume_meta)
from repro_torch.core.search import (Candidate, EpsParetoArchive, GenStats,
                                     MoveTables, Population, SearchResult,
                                     _validate_search_args, decode,
                                     move_tables, seeded_population)
from repro_torch.distributed.collectives import (all_reduce_, gather_islands,
                                                 group_rank, group_size,
                                                 ring_shift)
from repro_torch.neuromorphic.timestep import (_host, device_pricer,
                                               precompute_pricing,
                                               price_candidate,
                                               simulate_population)

log = logging.getLogger("repro_torch.resilience")

#: bottleneck-stage ids, in the (first-max-wins) vote order of
#: ``SimReport.bottleneck_stage`` and the pricer's ``stage``
STAGE_ID = {"memory": 0, "compute": 1, "traffic": 2, "barrier": 3}

_I32 = torch.int32
_F64 = torch.float64


# ------------------------------------------------------------ telemetry

class SearchTelemetry:
    """Instrumentation of one device-engine search run.

    Per generation (index 0 is the seed population's ``init``): the
    peel loop's iterations and the host reads, each a host sync on the
    card (one per peeled front plus the loop's last test, and one per
    stats-and-offspring or snapshot transfer).  Per stage of the step
    (``draws``, ``mutate``, ``pricing``, ``peel``, ``dedup``): the stream
    time between two CUDA events on the card, or the host clock on the
    CPU.  Recording costs two event records per stage and nothing else."""

    STAGES = ("draws", "mutate", "pricing", "peel", "dedup")

    def __init__(self):
        self.peel_iterations: list[int] = []
        self.host_syncs: list[int] = []
        self.stage_s = dict.fromkeys(self.STAGES, 0.0)
        self._events: list = []

    def generation(self) -> None:
        self.peel_iterations.append(0)
        self.host_syncs.append(0)

    def peel(self) -> None:
        if self.peel_iterations:
            self.peel_iterations[-1] += 1

    def sync(self) -> None:
        if self.host_syncs:
            self.host_syncs[-1] += 1

    @contextlib.contextmanager
    def span(self, name: str, device: torch.device):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self._events.append((name, a, b))
        else:
            t0 = time.perf_counter()
            yield
            self.stage_s[name] += time.perf_counter() - t0

    def settle(self) -> None:
        """Fold the recorded CUDA events into :attr:`stage_s` (after a
        host sync, when they have completed)."""
        for name, a, b in self._events:
            b.synchronize()
            self.stage_s[name] += a.elapsed_time(b) / 1e3
        self._events.clear()

    def summary(self) -> dict:
        self.settle()
        return dict(peel_iterations=list(self.peel_iterations),
                    host_syncs=list(self.host_syncs),
                    stage_s=dict(self.stage_s))


def _span(tel, name: str, device):
    return (tel.span(name, torch.device(device)) if tel is not None
            else contextlib.nullcontext())


def _fetch(tensors: dict, tel=None) -> dict:
    """All of ``tensors`` to the host in one transfer: integers ride as
    float64 (exact below 2**53) and come back in their own dtype."""
    tensors = {k: torch.as_tensor(v) for k, v in tensors.items()}
    flat = torch.cat([t.reshape(-1).to(_F64) for t in tensors.values()])
    host = flat.cpu().numpy()
    if tel is not None:
        tel.sync()
    out, pos = {}, 0
    for k, t in tensors.items():
        n = t.numel()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[k] = host[pos:pos + n].reshape(tuple(t.shape)).astype(dtype)
        pos += n
    return out


def _on(state: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in state.items()}


# ----------------------------------------------------------- PRNG contract

#: one generation's draws, in the order of the key's 8-way split
_DRAWS = ("tourn", "explore_u", "stage_r", "traffic_u", "split_pri",
          "merge_pri", "swap_iu", "swap_ju")


def island_draws(keys, *, n_off: int, n_pop: int, n_layers: int,
                 n_slots: int, tournament_k: int, device=None) -> dict:
    """:func:`generation_draws` of every key of the ``(n_islands, 2)``
    stack, island after island along each draw's row axis, from one
    threefry pass on ``device``."""
    keys = torch.as_tensor(keys).reshape(-1, 2).tolist()
    kt = max(1, int(tournament_k))
    shapes = dict(tourn=(n_off, kt), explore_u=(n_off,), stage_r=(n_off,),
                  traffic_u=(n_off,), split_pri=(n_off, n_layers),
                  merge_pri=(n_off, n_layers), swap_iu=(n_off,),
                  swap_ju=(n_off,))
    spans = dict(tourn=n_pop, stage_r=3)          # randint's [0, span)
    subs = [prng.split_words(k, 8) for k in keys]
    streams, sizes, layout = [], [], []
    for d, name in enumerate(_DRAWS):
        n = math.prod(shapes[name])
        if name in spans:
            # randint: the higher bits of every island, then the lower
            pairs = [prng.split_words(s[d]) for s in subs]
            streams += [p[0] for p in pairs] + [p[1] for p in pairs]
            sizes += [n] * (2 * len(keys))
        else:
            streams += [s[d] for s in subs]
            sizes += [n] * len(keys)
        layout.append((name, n * len(keys)))
    b1, b2 = prng.draw_streams(streams, sizes, device)
    out, pos = {}, 0
    for name, m in layout:
        rows = (len(keys) * shapes[name][0],) + shapes[name][1:]
        if name in spans:
            bits = b1[pos:pos + 2 * m] ^ b2[pos:pos + 2 * m]
            out[name] = prng._randint_from(bits[:m], bits[m:], 0,
                                           spans[name]).reshape(rows)
            pos += 2 * m
        else:
            out[name] = prng._uniform_from(b1[pos:pos + m],
                                           b2[pos:pos + m]).reshape(rows)
            pos += m
    return out


def generation_draws(key, *, n_off: int, n_pop: int, n_layers: int,
                     n_slots: int, tournament_k: int, device=None) -> dict:
    """One generation's complete randomness, from one key: the JAX
    package's fixed 8-way split consumed in a fixed order with explicit
    dtypes.  ``tourn`` (n_off, k) int32 parent indices; ``explore_u`` /
    ``stage_r`` the exploration coin and replacement stage; ``traffic_u``
    the merge-vs-swap coin; ``split_pri`` / ``merge_pri`` (n_off,
    n_layers) float64 priorities among feasible layers; ``swap_iu`` /
    ``swap_ju`` the swap gene positions."""
    return island_draws(torch.as_tensor(key).reshape(1, 2), n_off=n_off,
                        n_pop=n_pop, n_layers=n_layers, n_slots=n_slots,
                        tournament_k=tournament_k, device=device)


def island_keys(base_key, gen: int, n_islands: int) -> torch.Tensor:
    """The sharded engine's per-island keys: island ``i`` of generation
    ``g`` draws under ``fold_in(base_key, g * n_islands + i)``, which for
    one island is the device engine's ``fold_in(base_key, g)``.  Returns
    the ``(n_islands, 2)`` stack, on the host."""
    g, n = int(gen), int(n_islands)
    return torch.tensor([prng.fold_in_words(base_key, g * n + i)
                         for i in range(n)], dtype=torch.int64)


# ------------------------------------------------------- array-native moves

def mutate_rows_array(pc, pp, pstage, phot_mem, phot_act, draws, feasible,
                      n_phys: int, explore_prob: float):
    """Stacked table-gated mutation: parent rows -> offspring rows.

    Per offspring: the parent's bottleneck stage (or, with probability
    ``explore_prob``, and always on a "barrier" stage, a uniformly random
    stage) picks the move family.  memory / compute want a split of the
    hot layer (falling back to the feasible layer of highest random
    priority); traffic flips a coin between merge and swap.  An infeasible
    split falls to merge, an infeasible merge to swap.  A swap exchanges
    one expressed gene with any other gene, so it always changes the
    mapping and is always valid.  Ties in the priorities (all ``-1.0`` when
    nothing is feasible) go to the first layer, as numpy's ``argmax``."""
    n_off, n_layers = pc.shape
    n_slots = pp.shape[1]
    dev = pc.device
    pc64, pp64 = pc.long(), pp.long()
    lrange = torch.arange(n_layers, device=dev)
    neg = torch.tensor(-1.0, dtype=_F64, device=dev)

    explore = (draws["explore_u"] < explore_prob) | (pstage >= 3)
    s_eff = torch.where(explore, draws["stage_r"], pstage)

    total = pc64.sum(dim=1)
    split_feas = (feasible[lrange[None, :], pc64 + 1]
                  & ((total + 1) <= n_phys)[:, None])
    merge_feas = (pc64 > 1) & feasible[lrange[None, :], pc64 - 1]

    hot = torch.where(s_eff == 0, phot_mem, phot_act).long()
    hot_ok = split_feas.gather(1, hot[:, None])[:, 0]
    rand_split = torch.where(split_feas, draws["split_pri"], neg).argmax(1)
    split_l = torch.where(hot_ok, hot, rand_split)
    any_split = split_feas.any(dim=1)
    merge_l = torch.where(merge_feas, draws["merge_pri"], neg).argmax(1)
    any_merge = merge_feas.any(dim=1)

    want_split = s_eff <= 1
    traffic_merge = (s_eff == 2) & (draws["traffic_u"] < 0.5)
    do_split = want_split & any_split
    do_merge = ~do_split & any_merge & (traffic_merge | want_split)
    do_swap = ~(do_split | do_merge)

    oh_split = (lrange[None, :] == split_l[:, None]) & do_split[:, None]
    oh_merge = (lrange[None, :] == merge_l[:, None]) & do_merge[:, None]
    cores = pc64 + oh_split.long() - oh_merge.long()

    # swap: i an expressed gene, j any gene (i != j); the clamps guard the
    # u -> index map against u * total rounding up to total
    i = torch.minimum((draws["swap_iu"] * total).to(_I32).long(), total - 1)
    j = torch.minimum((draws["swap_ju"] * n_slots).to(_I32).long(),
                      torch.tensor(n_slots - 1, device=dev))
    j = torch.where(i == j, (j + 1) % n_slots, j)
    pi = pp64.gather(1, i[:, None])
    pj = pp64.gather(1, j[:, None])
    srange = torch.arange(n_slots, device=dev)
    swapped = torch.where(srange[None, :] == i[:, None], pj,
                          torch.where(srange[None, :] == j[:, None], pi,
                                      pp64))
    perm = torch.where(do_swap[:, None], swapped, pp64)
    return cores.to(_I32), perm.to(_I32)


def pareto_ranks_array(t, e, n_keep: int | None = None, *, tel=None):
    """Nondomination ranks by front peeling, the JAX package's
    ``lax.while_loop`` as a host loop: one host read of the stop flag per
    front.  ``t`` and ``e`` are ``(N,)`` or, one row per island, ``(I,
    N)``.  ``n_keep`` caps the peeling: an island stops once at least
    ``n_keep`` of its rows are ranked, and its unpeeled rows keep the
    sentinel rank ``N``, which sorts after every real rank."""
    single = t.dim() == 1
    if single:
        t, e = t[None], e[None]
    n_isl, n = t.shape
    cap = n if n_keep is None else min(int(n_keep), n)
    ti, tj = t[:, :, None], t[:, None, :]
    ei, ej = e[:, :, None], e[:, None, :]
    # dominated_by[., i, j]: row j dominates row i
    dominated_by = (tj <= ti) & (ej <= ei) & ((tj < ti) | (ej < ei))
    ranks = torch.full((n_isl, n), n, dtype=_I32, device=t.device)
    remaining = torch.ones((n_isl, n), dtype=torch.bool, device=t.device)
    peeled = torch.zeros(n_isl, dtype=torch.int64, device=t.device)
    r = 0
    with _span(tel, "peel", t.device):
        while True:
            active = remaining.any(dim=1) & (peeled < cap)
            go = bool(active.any())
            if tel is not None:
                tel.sync()
            if not go:
                break
            if tel is not None:
                tel.peel()
            dom = (dominated_by & remaining[:, None, :]).sum(dim=2)
            frontier = remaining & (dom == 0) & active[:, None]
            ranks = torch.where(frontier, r, ranks)
            remaining = remaining & ~frontier
            peeled = peeled + frontier.sum(dim=1)
            r += 1
    return ranks[0] if single else ranks


def _lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` along the last axis of ``(I, N)`` keys (the last key
    is the primary one), by stable sorts from the least significant key
    up; the row index is the final tie-break, so the order is total."""
    n_isl, n = keys[0].shape
    idx = torch.arange(n, device=keys[0].device).expand(n_isl, n)
    for k in keys:
        idx = idx.gather(1, torch.argsort(k.gather(1, idx), dim=1,
                                          stable=True))
    return idx


def _pack(genes: torch.Tensor, vmax: int) -> torch.Tensor:
    """``(..., G)`` genes in ``[0, vmax]`` packed into ``(..., W)`` int64
    words of equal bit fields: rows are equal iff their words are."""
    bits = max(1, int(vmax).bit_length())
    per = 63 // bits
    G = genes.shape[-1]
    W = -(-G // per)
    g = torch.nn.functional.pad(genes.long(), (0, W * per - G))
    shifts = torch.arange(per, device=g.device) * bits
    return (g.reshape(*g.shape[:-1], W, per) << shifts).sum(dim=-1)


def _survival_order(cores, perm, times, energies, ranks, n_keep: int,
                    gene_max: int | None = None, tel=None) -> torch.Tensor:
    """Per island: indices of the ``n_keep`` best phenotype-unique rows of
    ``(I, N, .)`` rows under (rank, time, energy, index) -> ``(I,
    n_keep)``."""
    dev = cores.device
    n_isl, n = times.shape
    with _span(tel, "dedup", dev):
        order = _lexsort((energies, times, ranks))
        oc = torch.take_along_dim(cores, order[..., None], dim=1).long()
        op = torch.take_along_dim(perm, order[..., None], dim=1).long()
        n_log = oc.sum(dim=-1)
        # unexpressed genes are masked: a dead-tail difference is the same
        # phenotype (the array form of Population.row_key)
        srange = torch.arange(perm.shape[-1], device=dev)
        pm = torch.where(srange < n_log[..., None], op, -1)
        genome = torch.cat([oc, pm], dim=-1) + 1          # >= 0
        if gene_max is None:
            gene_max = int(genome.max()) if genome.numel() else 0
        words = _pack(genome, gene_max)
        # equal phenotypes become adjacent, best survival position first
        gsort = _lexsort([words[..., w] for w in range(words.shape[-1])])
        gg = torch.take_along_dim(words, gsort[..., None], dim=1)
        eq_prev = torch.cat(
            [torch.zeros((n_isl, 1), dtype=torch.bool, device=dev),
             (gg[:, 1:] == gg[:, :-1]).all(dim=-1)], dim=1)
        dup = torch.zeros((n_isl, n), dtype=torch.bool, device=dev)
        dup = dup.scatter(1, gsort, eq_prev)
        sel = torch.argsort(dup.to(torch.int8), dim=1, stable=True)
        return order.gather(1, sel[:, :n_keep])


def survival_order_array(cores, perm, times, energies, ranks, n_keep: int,
                         *, gene_max: int | None = None, tel=None):
    """Elitist survival on stacked rows: indices of the ``n_keep`` best
    phenotype-unique rows under the total order (rank, time, energy,
    index).

    The order is the JAX package's ``lexsort``, built from stable sorts.
    Dedup keeps, of each group of equal phenotypes (unexpressed
    permutation genes masked to -1), the best-placed row: the genome
    columns are packed into a few int64 words of ``gene_max + 1``-bit
    fields, rows are sorted by them with survival position as the final
    tie-break, and a row equal to its predecessor is a duplicate.  This
    selects exactly the JAX package's rows (its sort over all the genome
    columns groups the same rows, in another order of the groups).  If
    fewer than ``n_keep`` unique rows exist, the best duplicates pad the
    batch.  ``gene_max`` bounds ``genome + 1`` (the engines pass their
    static bound; by default it is read from the data)."""
    idx = _survival_order(cores[None], perm[None], times[None],
                          energies[None], ranks[None], n_keep, gene_max,
                          tel)
    return idx[0]


# ------------------------------------------------- shared step bookkeeping

_OUT_KEYS = ("times", "energies", "stage", "hot_mem", "hot_act")


def _sorted_state(cores, perm, out: dict, n_keep: int, *,
                  n_islands: int = 1, gene_max: int | None = None,
                  tel=None) -> dict:
    """Price outputs + genome rows (island-block order) -> each island's
    ``n_keep`` survivors, sorted.  Non-finite objectives are quarantined
    first (sentinel ``(+inf, +inf)``; finite rows pass bit-unchanged), so a
    NaN row cannot rank 0."""
    t, e, _ = quarantine_rows(torch, out["times"], out["energies"])
    n = t.shape[0] // n_islands
    shape = lambda a: a.reshape(n_islands, n, *a.shape[1:])
    ranks = pareto_ranks_array(shape(t), shape(e), n_keep=n_keep, tel=tel)
    local = _survival_order(shape(cores), shape(perm), shape(t), shape(e),
                            ranks, n_keep, gene_max, tel)
    base = torch.arange(n_islands, device=t.device)[:, None] * n
    idx = (local + base).reshape(-1)
    return dict(cores=cores[idx], perm=perm[idx], times=t[idx],
                energies=e[idx], stage=out["stage"][idx],
                hot_mem=out["hot_mem"][idx], hot_act=out["hot_act"][idx])


def _migrate(state: dict, n_migrants: int, n_islands: int, group=None,
             **kw) -> dict:
    """Elite-block rotation: island ``i``'s rows ``[0, n_migrants)`` are
    replaced by island ``i - 1``'s, then every island re-sorts.  Rows move,
    none is copied or dropped.  With a ``group`` the ``n_islands`` are this
    rank's block of the ring: its first island receives the last island
    of the rank before it (:func:`~repro_torch.distributed.collectives.
    ring_shift`)."""
    P = state["cores"].shape[0] // n_islands
    m = int(n_migrants)

    def rotate(a):
        b = a.reshape(n_islands, P, *a.shape[1:])
        inc = torch.roll(b[:, :m], shifts=1, dims=0)
        if group is not None:
            edge = ring_shift(b[-1:, :m], size=group_size(group),
                              group=group)
            inc = torch.cat([edge, inc[1:]])
        return torch.cat([inc, b[:, m:]], dim=1).flatten(0, 1)

    merged = {k: rotate(v) for k, v in state.items()}
    return _sorted_state(merged["cores"], merged["perm"], merged, P,
                         n_islands=n_islands, **kw)


def _island_stats(new: dict, n_islands: int, n_quar, group=None) -> dict:
    """The generation's stats over every island: the best island leader
    (least time, then least energy), the finite mean time over all
    survivors and the quarantined offspring; for one island the device
    engine's ``times[0]``, ``energies[0]`` and :func:`finite_mean`.  With
    a ``group`` the leaders of every rank's islands are gathered and the
    finite sums and counts summed over it (the JAX package's
    ``_global_stats``)."""
    t = new["times"].reshape(n_islands, -1)[:, 0]
    e = new["energies"].reshape(n_islands, -1)[:, 0]
    if group is not None:
        lead = gather_islands(dict(t=t, e=e), group=group, tiled=True)
        t, e = lead["t"], lead["e"]
    tmin = t.min()
    inf = torch.tensor(float("inf"), dtype=e.dtype, device=e.device)
    if group is None:
        mean = finite_mean(torch, new["times"])
    else:
        times = new["times"]
        ok = torch.isfinite(times)
        n_ok = all_reduce_(ok.sum(), group)
        total = all_reduce_(torch.where(ok, times, 0.0).sum(), group)
        mean = torch.where(n_ok > 0, total / n_ok.clamp(min=1), inf)
        n_quar = all_reduce_(torch.as_tensor(n_quar).clone(), group)
    return dict(best_time=tmin, best_energy=torch.where(t == tmin, e,
                                                        inf).min(),
                mean_time=mean, n_quarantined=n_quar)


def _generation_step(price_fn, feasible, n_phys: int, explore_prob: float,
                     state: dict, draws: dict, *, n_islands: int = 1,
                     n_migrants: int = 0, gene_max: int | None = None,
                     tel=None, group=None):
    """One (mu + lambda) generation on every island: select, mutate,
    price, join each island's offspring to its survivors, rank, survive
    (then migrate, with ``n_migrants``).  Returns (new state, offspring
    dict, stats dict).  With a ``group`` the islands are this rank's block
    and migration and stats cross ranks."""
    I = n_islands
    P = state["cores"].shape[0] // I
    n_off = draws["explore_u"].shape[0] // I
    dev = state["cores"].device
    with _span(tel, "mutate", dev):
        island = torch.arange(I, device=dev).repeat_interleave(n_off)
        parents = draws["tourn"].min(dim=1).values.long() + island * P
        oc, op = mutate_rows_array(
            state["cores"][parents], state["perm"][parents],
            state["stage"][parents], state["hot_mem"][parents],
            state["hot_act"][parents], draws, feasible, n_phys,
            explore_prob)
    with _span(tel, "pricing", dev):
        out = price_fn(oc, op)

    def join(a, b):
        return torch.cat([a.reshape(I, P, *a.shape[1:]),
                          b.reshape(I, n_off, *b.shape[1:])],
                         dim=1).flatten(0, 1)

    all_out = {k: join(state[k], out[k]) for k in _OUT_KEYS}
    kw = dict(n_islands=I, gene_max=gene_max, tel=tel)
    new = _sorted_state(join(state["cores"], oc), join(state["perm"], op),
                        all_out, P, **kw)
    if n_migrants:
        new = _migrate(new, n_migrants, group=group, **kw)
    off = dict(cores=oc, perm=op, times=out["times"],
               energies=out["energies"])
    n_quar = (~(torch.isfinite(out["times"])
                & torch.isfinite(out["energies"]))).sum()
    return new, off, _island_stats(new, I, n_quar, group)


# ----------------------------------------------------------------- engines

class _GenerationProgram:
    """The generation program bound to a move table, a device and an
    island geometry; subclasses supply the pricing."""

    def __init__(self, tables: MoveTables, *, n_layers: int, n_slots: int,
                 device, explore_prob: float, tournament_k: int,
                 n_islands: int = 1, n_migrants: int = 0, group=None):
        self.device = torch.device(device)
        #: the process group the islands are spread over (None: one rank)
        self.group = group
        self.explore_prob = float(explore_prob)
        self.tournament_k = int(tournament_k)
        self.n_layers = int(n_layers)
        self.n_slots = int(n_slots)
        self.n_phys = int(tables.n_cores_phys)
        self.n_islands = int(n_islands)
        self.n_migrants = int(n_migrants)
        self.feasible = torch.as_tensor(tables.feasible, device=self.device)
        # bound on genome + 1 in survival's dedup: cores <= n_phys,
        # permutation genes < n_slots
        self.gene_max = max(self.n_phys + 1, self.n_slots)
        #: the run's :class:`SearchTelemetry` (set by the driver)
        self.tel = None

    def _price(self, cores, perm) -> dict:
        raise NotImplementedError

    def _kw(self) -> dict:
        return dict(n_islands=self.n_islands, gene_max=self.gene_max,
                    tel=self.tel)

    def init(self, cores, perm):
        """Price and sort the seed population (island-block order)."""
        cores = torch.as_tensor(np.asarray(cores), dtype=_I32).to(
            self.device)
        perm = torch.as_tensor(np.asarray(perm), dtype=_I32).to(self.device)
        with _span(self.tel, "pricing", self.device):
            out = self._price(cores, perm)
        state = _sorted_state(cores, perm, out,
                              cores.shape[0] // self.n_islands, **self._kw())
        return state, dict(times=out["times"], energies=out["energies"])

    def step(self, state: dict, keys, n_off: int, migrate: bool = False):
        """One generation on every island from the ``(n_islands, 2)``
        keys (:func:`island_keys`); ``n_off`` offspring per island."""
        state = _on(state, self.device)
        with _span(self.tel, "draws", self.device):
            draws = island_draws(
                keys, n_off=n_off,
                n_pop=state["cores"].shape[0] // self.n_islands,
                n_layers=self.n_layers, n_slots=self.n_slots,
                tournament_k=self.tournament_k, device=self.device)
        return _generation_step(
            self._price, self.feasible, self.n_phys, self.explore_prob,
            state, draws, n_migrants=self.n_migrants if migrate else 0,
            group=self.group, **self._kw())

    def migrate(self, state: dict) -> dict:
        """The migration alone (the unit the multiset property drives)."""
        return _migrate(_on(state, self.device), self.n_migrants,
                        group=self.group, **self._kw())


class DeviceSearchEngine(_GenerationProgram):
    """One workload's generation machinery on the pricing cache's device,
    priced by the cache's :class:`~repro_torch.neuromorphic.timestep.
    DevicePopulationPricer` (:func:`~repro_torch.neuromorphic.timestep.
    device_pricer`).  State is a dict of device tensors ``{cores, perm,
    times, energies, stage, hot_mem, hot_act}`` kept (rank, time,
    energy)-sorted."""

    def __init__(self, net, profile, cache, tables: MoveTables, *,
                 explore_prob: float, tournament_k: int, n_islands: int = 1,
                 n_migrants: int = 0, group=None):
        self.pricer = device_pricer(net, profile, cache)
        super().__init__(tables, n_layers=len(cache.layers),
                         n_slots=int(profile.n_cores),
                         device=self.pricer.device,
                         explore_prob=explore_prob,
                         tournament_k=tournament_k, n_islands=n_islands,
                         n_migrants=n_migrants, group=group)

    def _price(self, cores, perm) -> dict:
        o = self.pricer.price(cores.long(), perm.long())
        return dict(times=o["time_per_step"], energies=o["energy_per_step"],
                    stage=o["stage"].to(_I32), hot_mem=o["hot_mem"].to(_I32),
                    hot_act=o["hot_act"].to(_I32))


class ShardedSearchEngine(DeviceSearchEngine):
    """The island model: ``n_islands`` islands of ``local_pop`` rows in
    island-block order, every island's generation in one program,
    migration a rotation of the island axis.  With a process ``group``
    the ``n_islands`` are this rank's block of the ring (``_search`` gives
    rank ``r`` islands ``[r * n_islands, (r + 1) * n_islands)``)."""

    def __init__(self, net, profile, cache, tables: MoveTables, *,
                 n_islands: int, local_pop: int, n_migrants: int,
                 explore_prob: float, tournament_k: int, group=None):
        super().__init__(net, profile, cache, tables,
                         explore_prob=explore_prob,
                         tournament_k=tournament_k, n_islands=n_islands,
                         n_migrants=n_migrants, group=group)
        self.local_pop = int(local_pop)


def _engine_for(net, profile, cache, tables, *, explore_prob, tournament_k,
                n_islands: int = 1, local_pop: int = 0,
                n_migrants: int = 0, group=None) -> DeviceSearchEngine:
    """The engine for one run: the device engine, or the island engine
    when the geometry has migrants.  Nothing is compiled, so each run
    builds its own (the JAX package caches its jitted engines on the
    pricer), and a run's telemetry is never shared with another's."""
    if n_islands == 1 and not n_migrants:
        return DeviceSearchEngine(net, profile, cache, tables,
                                  explore_prob=explore_prob,
                                  tournament_k=tournament_k)
    return ShardedSearchEngine(net, profile, cache, tables,
                               n_islands=n_islands, local_pop=local_pop,
                               n_migrants=n_migrants,
                               explore_prob=explore_prob,
                               tournament_k=tournament_k, group=group)


# -------------------------------------------------------- reference mirrors

class _NumpyMirror(_GenerationProgram):
    """Host replay of the device engine under the shared PRNG-key
    contract: the same program on CPU tensors, the draws by
    :mod:`~repro_torch.core.prng` on the CPU, and the pricing by the
    bit-exact ``"numpy"`` population backend.  The specification the
    device engine is held to, and its demotion target."""

    backend = "numpy-mirror"

    def __init__(self, net, xs, profile, cache, tables, *, explore_prob,
                 tournament_k, fault_plan: FaultPlan | None = None):
        super().__init__(tables, n_layers=len(cache.layers),
                         n_slots=int(profile.n_cores), device="cpu",
                         explore_prob=explore_prob,
                         tournament_k=tournament_k)
        self.net, self.xs, self.profile, self.cache = net, xs, profile, cache
        #: scripted NaN pricing rows land here
        self.fault_plan = fault_plan

    def _price(self, cores, perm) -> dict:
        c = cores.numpy()
        reports = simulate_population(self.net, self.xs, self.profile,
                                      Population(c, perm.numpy()).pairs(),
                                      cache=self.cache)
        t = np.asarray([r.time_per_step for r in reports], np.float64)
        e = np.asarray([r.energy_per_step for r in reports], np.float64)
        if self.fault_plan is not None:
            t, e = self.fault_plan.corrupt_arrays(t, e)
        stage = [STAGE_ID[r.bottleneck_stage] for r in reports]
        hot_mem, hot_act = [], []
        for k, r in enumerate(reports):
            lids = np.repeat(np.arange(self.n_layers), c[k])
            hot_mem.append(lids[int(np.argmax(_host(r.per_core_synops)))])
            hot_act.append(lids[int(np.argmax(_host(r.per_core_acts)))])
        i32 = lambda v: torch.as_tensor(np.asarray(v, np.int32))
        return dict(times=torch.as_tensor(t), energies=torch.as_tensor(e),
                    stage=i32(stage), hot_mem=i32(hot_mem),
                    hot_act=i32(hot_act))


class _ShardedHostMirror:
    """Host replay of the island engine, island by island: one
    :class:`_NumpyMirror` generation per island block (row ``i`` of the
    :func:`island_keys` stack), then migration in list form (island ``i``
    receives island ``i - 1``'s elites and re-sorts).  The specification
    the sharded engine is held to, and its demotion target."""

    backend = "numpy-mirror"

    def __init__(self, net, xs, profile, cache, tables, *, n_islands,
                 local_pop, n_migrants, explore_prob, tournament_k,
                 fault_plan: FaultPlan | None = None):
        self.base = _NumpyMirror(net, xs, profile, cache, tables,
                                 explore_prob=explore_prob,
                                 tournament_k=tournament_k,
                                 fault_plan=fault_plan)
        self.device = self.base.device
        self.n_islands = int(n_islands)
        self.local_pop = int(local_pop)
        self.n_migrants = int(n_migrants)

    @property
    def tel(self):
        return self.base.tel

    @tel.setter
    def tel(self, value):
        self.base.tel = value

    def _blocks(self, state: dict) -> list[dict]:
        L = self.local_pop
        state = _on(state, "cpu")
        return [{k: v[i * L:(i + 1) * L] for k, v in state.items()}
                for i in range(self.n_islands)]

    @staticmethod
    def _cat(blocks: list[dict]) -> dict:
        return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}

    def _stats(self, blocks: list[dict], n_quar: int) -> dict:
        ts = torch.stack([b["times"][0] for b in blocks])
        es = torch.stack([b["energies"][0] for b in blocks])
        tmin = ts.min()
        emin = torch.where(ts == tmin, es, float("inf")).min()
        ok = [torch.isfinite(b["times"]) for b in blocks]
        n_ok = sum(int(m.sum()) for m in ok)
        total = sum(float(torch.where(m, b["times"], 0.0).sum())
                    for b, m in zip(blocks, ok))
        mean = total / max(n_ok, 1) if n_ok > 0 else float("inf")
        return dict(best_time=tmin, best_energy=emin,
                    mean_time=torch.tensor(mean, dtype=_F64),
                    n_quarantined=torch.tensor(n_quar))

    def init(self, cores, perm):
        cores = np.asarray(cores)
        perm = np.asarray(perm)
        L = self.local_pop
        states, times, energies = [], [], []
        for i in range(self.n_islands):
            st, out = self.base.init(cores[i * L:(i + 1) * L],
                                     perm[i * L:(i + 1) * L])
            states.append(st)
            times.append(out["times"])
            energies.append(out["energies"])
        return self._cat(states), dict(times=torch.cat(times),
                                       energies=torch.cat(energies))

    def _migrate(self, blocks: list[dict]) -> list[dict]:
        m = self.n_migrants
        elites = [{k: v[:m] for k, v in b.items()} for b in blocks]
        incoming = elites[-1:] + elites[:-1]
        out = []
        for b, inc in zip(blocks, incoming):
            merged = {k: torch.cat([inc[k], b[k][m:]]) for k in b}
            out.append(_sorted_state(merged["cores"], merged["perm"], merged,
                                     self.local_pop,
                                     gene_max=self.base.gene_max,
                                     tel=self.base.tel))
        return out

    def migrate(self, state: dict) -> dict:
        return self._cat(self._migrate(self._blocks(state)))

    def step(self, state: dict, keys, n_off: int, migrate: bool = False):
        keys = torch.as_tensor(keys).reshape(-1, 2)
        new_blocks, offs, n_quar = [], [], 0
        for i, blk in enumerate(self._blocks(state)):
            nb, off, st = self.base.step(blk, keys[i:i + 1], n_off)
            new_blocks.append(nb)
            offs.append(off)
            n_quar += int(st["n_quarantined"])
        if migrate:
            new_blocks = self._migrate(new_blocks)
        return (self._cat(new_blocks), self._cat(offs),
                self._stats(new_blocks, n_quar))


# ------------------------------------------------------ degradation shell

class _ResilientEngine:
    """Graceful-degradation shell around a device engine.

    A failed ``init`` / ``step`` (a device fault, an out-of-memory, or one
    injected at the :class:`FaultPlan` site ``"device"`` or ``"sharded"``)
    is retried per the :class:`RetryPolicy`, sleeping ``backoff_s *
    multiplier**attempt`` between attempts; when the retries are spent the
    engine demotes permanently to its host mirror, recording
    ``Demotion(frm="device" | "sharded", to="numpy-mirror")``.  The mirror
    consumes the same draws under the same key contract, so a mid-run
    demotion continues the trajectory to float64 roundoff; a mirror
    failure propagates.  With ``demote=False`` (islands over a process
    group) the failure propagates instead: a rank that demoted alone would
    leave the others waiting in a collective."""

    def __init__(self, primary, mirror_factory, *,
                 retry: RetryPolicy | None = None,
                 fault_plan: FaultPlan | None = None,
                 backend: str = "device", demote: bool = True):
        self.engine = primary
        self.demote = demote
        self._mirror_factory = mirror_factory
        self.retry = retry or RetryPolicy()
        self.fault_plan = fault_plan
        self._primary = str(backend)
        self.backend = self._primary
        self.demotions: list[Demotion] = []

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def tel(self):
        return self.engine.tel

    @tel.setter
    def tel(self, value):
        self.engine.tel = value

    def _run(self, call, site: str):
        while True:
            delay = self.retry.backoff_s
            last = None
            for a in range(self.retry.max_retries + 1):
                if a and delay > 0:
                    time.sleep(delay)
                    delay *= self.retry.multiplier
                try:
                    if self.fault_plan is not None:
                        self.fault_plan.check(self.backend)
                    return call(self.engine)
                except Exception as e:          # SimulatedCrash passes:
                    last = e                    # it is a BaseException
            if self.backend != self._primary or not self.demote:
                raise last                      # mirror failed: no net left
            d = Demotion(site=site, frm=self._primary, to="numpy-mirror",
                         error=repr(last), retries=self.retry.max_retries)
            self.demotions.append(d)
            log.warning("%s search engine failed %s after %d retries "
                        "(%s); demoting to the host numpy mirror",
                        self._primary, site, d.retries, d.error)
            tel = self.engine.tel
            self.engine = self._mirror_factory()
            self.engine.tel = tel
            self.backend = "numpy-mirror"

    def init(self, cores, perm):
        return self._run(lambda e: e.init(cores, perm), "init")

    def step(self, state, keys, n_off: int, migrate: bool = False):
        return self._run(lambda e: e.step(state, keys, n_off, migrate),
                         "step")


# ----------------------------------------------------------------- driver

#: the engine's state dict, in checkpoint order
_STATE_KEYS = ("cores", "perm", "times", "energies", "stage", "hot_mem",
               "hot_act")


def _charge(evaluator, n: int) -> None:
    """Record ``n`` candidate pricings on the evaluator's ledger;
    evaluators without a counter are left alone."""
    if hasattr(evaluator, "n_evals"):
        evaluator.n_evals += int(n)


def _search(net, profile, evaluator, *, engine: str, population_size: int,
            generations: int, tournament_k: int, explore_prob: float,
            seed: int, max_evaluations, seed_candidates, greedy,
            pareto_eps: float, n_islands, migrate_every: int, n_migrants,
            reference: bool, checkpoint_dir, checkpoint_every: int,
            checkpoint_keep: int, resume: bool, fault_plan, retry,
            group=None):
    """The shared driver of :func:`evolutionary_search_device` and
    :func:`evolutionary_search_sharded` (``engine`` names which)."""
    sharded = engine == "sharded"
    R, rank = group_size(group), group_rank(group)
    for attr in ("net", "xs", "profile"):
        if not hasattr(evaluator, attr):
            raise TypeError(
                f"engine={engine!r} needs a SimEvaluator-like evaluator "
                f"(missing .{attr}); plain callables can only drive the "
                "numpy engine")
    _validate_search_args(net, profile, population_size=population_size,
                          generations=generations,
                          seed_candidates=seed_candidates)
    n_islands = int(n_islands or 1) if sharded else 1
    if n_islands < 1:
        raise ValueError(f"n_islands must be >= 1, got {n_islands}")
    if population_size % n_islands:
        raise ValueError(
            f"population_size={population_size} does not divide evenly "
            f"over {n_islands} islands — pick a multiple of {n_islands} "
            "or pass n_islands explicitly")
    local_pop = population_size // n_islands
    if group is not None:
        if not sharded or reference:
            raise ValueError("a process group spreads the sharded engine's "
                             "islands; it has no mirror over ranks")
        if n_islands % R:
            raise ValueError(f"{n_islands} islands over {R} ranks")
    I_loc = n_islands // R                # this rank's islands
    mine = slice(rank * I_loc * local_pop, (rank + 1) * I_loc * local_pop)

    def gathered(tensors: dict) -> dict:
        """Every rank's rows of ``tensors``, in island order."""
        if group is None:
            return tensors
        return gather_islands(tensors, group=group, tiled=True)
    if local_pop < 2:
        raise ValueError(
            f"population_size={population_size} over {n_islands} islands "
            f"leaves {local_pop} row(s) per island; tournament selection "
            "needs at least 2 — lower n_islands or grow the population")
    migrate_every = int(migrate_every)
    if sharded:
        if n_migrants is None:
            n_migrants = max(1, local_pop // 8)
        n_migrants = int(n_migrants)
        if not 1 <= n_migrants <= local_pop:
            raise ValueError(f"n_migrants={n_migrants} must be in "
                             f"[1, {local_pop}] (the island size)")
    else:
        n_migrants = 0

    xs = evaluator.xs
    cache = getattr(evaluator, "cache", None) \
        or precompute_pricing(net, xs, profile)
    ckpt = (SearchCheckpointer(checkpoint_dir, every=checkpoint_every,
                               keep=checkpoint_keep)
            if checkpoint_dir else None)
    restored = ckpt.restore() if (ckpt is not None and resume) else None
    tables = move_tables(net, profile)
    n_layers, n_slots = len(cache.layers), int(profile.n_cores)

    def _mirror():
        if sharded:
            return _ShardedHostMirror(
                net, xs, profile, cache, tables, n_islands=n_islands,
                local_pop=local_pop, n_migrants=n_migrants,
                explore_prob=explore_prob, tournament_k=tournament_k,
                fault_plan=fault_plan)
        return _NumpyMirror(net, xs, profile, cache, tables,
                            explore_prob=explore_prob,
                            tournament_k=tournament_k,
                            fault_plan=fault_plan)

    if reference:
        eng = _mirror()
    else:
        eng = _ResilientEngine(
            _engine_for(net, profile, cache, tables,
                        explore_prob=explore_prob, tournament_k=tournament_k,
                        n_islands=I_loc, local_pop=local_pop,
                        n_migrants=n_migrants, group=group),
            _mirror, fault_plan=fault_plan, backend=engine,
            retry=retry if group is None else RetryPolicy(max_retries=0),
            demote=group is None)
    tel = SearchTelemetry()
    eng.tel = tel
    base_key = prng.PRNGKey(seed)
    archive = EpsParetoArchive(pareto_eps)
    geometry = (dict(population_size=int(population_size),
                     n_islands=n_islands, migrate_every=migrate_every,
                     n_migrants=n_migrants) if sharded else {})

    if restored is not None:
        arrays, gen0, meta = restored
        validate_resume_meta(meta, engine=engine,
                             checkpoint_dir=checkpoint_dir,
                             expect=geometry or None)
        state = {k: torch.as_tensor(np.asarray(arrays[k])[mine]).to(
            _F64 if k in ("times", "energies") else _I32)
            for k in _STATE_KEYS}
        archive.load_state(arrays)
        history = [GenStats(**h) for h in meta["history"]]
        evals_used = int(meta["evals_used"])
        seed_best_time = float(meta["seed_best_time"])
        n_pop = int(np.asarray(arrays["cores"]).shape[0])   # every rank's
        start_gen = gen0 + 1
    else:
        rng = np.random.default_rng(seed)
        cands = list(seed_candidates if seed_candidates is not None else
                     seeded_population(net, profile, size=population_size,
                                       rng=rng, greedy=greedy))
        if not cands:
            raise ValueError("empty initial population")
        if sharded and len(cands) != population_size:
            raise ValueError(
                f"{len(cands)} seed candidates do not fill "
                f"population_size={population_size} (the sharded engine "
                "needs full equal islands)")
        if not sharded and max_evaluations is not None:
            cands = cands[:max(1, max_evaluations)]
        pop = Population.from_candidates(cands)
        tel.generation()
        state, init_out = eng.init(pop.cores[mine], pop.perm[mine])
        evals_used = len(pop)
        _charge(evaluator, len(pop))
        h = _fetch(gathered(dict(it=init_out["times"],
                                 ie=init_out["energies"],
                                 ft=state["times"], fe=state["energies"])),
                   tel)
        tel.settle()
        # screen the raw seed objectives before they reach host stats or
        # the archive
        it, ie, _ = quarantine_rows(np, h["it"], h["ie"])
        seed_best_time = float(np.min(it))
        archive.update_batch(it, ie, pop.cores, pop.perm)
        ft = h["ft"].reshape(n_islands, -1)[:, 0]
        fe = h["fe"].reshape(n_islands, -1)[:, 0]
        tmin = float(np.min(ft))
        history = [GenStats(generation=0, best_time=tmin,
                            best_energy=float(np.min(np.where(
                                ft == tmin, fe, np.inf))),
                            mean_time=float(finite_mean(np, h["ft"])),
                            n_evals=evals_used, front_size=len(archive))]
        n_pop = len(pop)
        start_gen = 1

    def _snapshot(gen: int) -> None:
        arrays = _fetch(gathered({k: state[k] for k in _STATE_KEYS}), tel)
        if rank == 0:
            arrays.update(archive.state_arrays(n_layers, n_slots))
            meta = dict(engine=engine, **geometry,
                        evals_used=int(evals_used),
                        seed_best_time=float(seed_best_time),
                        history=[dataclasses.asdict(g) for g in history])
            ckpt.save(gen, arrays, meta)
        if group is not None:
            dist.barrier(group=group)

    if restored is None:
        if ckpt is not None:
            _snapshot(0)
        if fault_plan is not None:
            fault_plan.after_generation(0)

    for gen in range(start_gen, generations + 1):
        n_off = n_pop
        if max_evaluations is not None:
            n_off = min(n_off, max_evaluations - evals_used)
        local_off = n_off // n_islands
        if local_off <= 0:
            break
        migrate = (n_islands > 1 and migrate_every > 0
                   and gen % migrate_every == 0)
        tel.generation()
        keys = island_keys(base_key, gen, n_islands)
        state, off, stats = eng.step(state,
                                     keys[rank * I_loc:(rank + 1) * I_loc],
                                     local_off, migrate)
        off = gathered(off)
        evals_used += local_off * n_islands
        _charge(evaluator, local_off * n_islands)
        # the per-generation host transfer: the stats and the offspring,
        # absorbed by the epsilon-Pareto archive in one vectorized update
        h = _fetch(dict(stats=torch.stack([stats[k].to(_F64) for k in (
            "best_time", "best_energy", "mean_time", "n_quarantined")]),
            **off), tel)
        tel.settle()
        archive.update_batch(h["times"], h["energies"], h["cores"],
                             h["perm"])
        s = h["stats"]
        history.append(GenStats(
            generation=gen, best_time=float(s[0]), best_energy=float(s[1]),
            mean_time=float(s[2]), n_evals=evals_used,
            front_size=len(archive), n_quarantined=int(s[3])))
        if ckpt is not None and ckpt.due(gen, generations):
            _snapshot(gen)
        if fault_plan is not None:
            fault_plan.after_generation(gen)

    final = _fetch(gathered({k: state[k] for k in ("cores", "perm",
                                                   "times", "energies")}))
    t0 = final["times"].reshape(n_islands, -1)[:, 0]
    e0 = final["energies"].reshape(n_islands, -1)[:, 0]
    row = int(np.argmin(np.where(t0 == t0.min(), e0, np.inf))) \
        * (final["times"].shape[0] // n_islands)
    best = Candidate(tuple(int(x) for x in final["cores"][row]),
                     tuple(int(x) for x in final["perm"][row]))
    part, mapping = decode(best)
    # stats-only materialization through the bit-exact path (uncharged)
    best_report = price_candidate(net, profile, cache, part, mapping)
    front, _ = archive.front()
    front_reports = simulate_population(net, xs, profile,
                                        [decode(c) for c in front],
                                        cache=cache) if front else []
    return SearchResult(candidate=best, partition=part, mapping=mapping,
                        report=best_report, history=history,
                        n_evals=evals_used, seed_best_time=seed_best_time,
                        front=front, front_reports=front_reports,
                        demotions=list(getattr(eng, "demotions", ())),
                        telemetry=dict(tel.summary(), backend=eng.backend))


def evolutionary_search_device(
    net,
    profile,
    evaluator,
    *,
    population_size: int = 24,
    generations: int = 16,
    tournament_k: int = 3,
    explore_prob: float = 0.25,
    seed: int = 0,
    max_evaluations: int | None = None,
    seed_candidates=None,
    greedy=None,
    pareto_eps: float = 0.01,
    reference: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 3,
    resume: bool = False,
    fault_plan: FaultPlan | None = None,
    retry: RetryPolicy | None = None,
) -> SearchResult:
    """Run the device-resident (mu + lambda) search (the ``engine="device"``
    path of :func:`repro_torch.core.search.evolutionary_search`) on the
    device of the evaluator's pricing cache.

    ``evaluator`` must be :class:`~repro_torch.core.partitioner.
    SimEvaluator`-like (``net`` / ``xs`` / ``profile``, ideally a
    ``cache``): the engine prices inside its own step, so the evaluator is
    the source of the pricing cache and the evaluation ledger (``n_evals``
    is charged per generation).  The best candidate's report and the
    archive's ``front_reports`` are re-priced once at the end through the
    bit-exact numpy path, uncharged.  ``reference=True`` runs the host
    mirror instead (same draws, numpy pricing, the same trajectory to
    float64 roundoff).

    Fault tolerance: ``checkpoint_dir`` / ``checkpoint_every`` /
    ``checkpoint_keep`` / ``resume`` snapshot and restore the state dict
    in the JAX package's layout (meta ``engine="device"``); resume is
    bit-identical, each generation being a pure function of (key, gen,
    survivors).  A failed ``init`` / ``step`` is retried per ``retry``,
    then demoted to the host mirror (``SearchResult.demotions``).
    ``fault_plan``: ``fail={"device": n}`` fails the next ``n`` engine
    calls, ``nan_rows`` corrupts mirror pricing rows, ``kill_after_gen``
    simulates a crash after that generation's snapshot.
    ``SearchResult.telemetry`` holds :class:`SearchTelemetry`'s summary
    and the backend that ran the last generation (``"device"``, or
    ``"numpy-mirror"`` after a demotion or with ``reference=True``).
    """
    return _search(net, profile, evaluator, engine="device",
                   population_size=population_size, generations=generations,
                   tournament_k=tournament_k, explore_prob=explore_prob,
                   seed=seed, max_evaluations=max_evaluations,
                   seed_candidates=seed_candidates, greedy=greedy,
                   pareto_eps=pareto_eps, n_islands=1, migrate_every=0,
                   n_migrants=None, reference=reference,
                   checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every,
                   checkpoint_keep=checkpoint_keep, resume=resume,
                   fault_plan=fault_plan, retry=retry)


def evolutionary_search_sharded(
    net,
    profile,
    evaluator,
    *,
    population_size: int = 24,
    generations: int = 16,
    tournament_k: int = 3,
    explore_prob: float = 0.25,
    seed: int = 0,
    max_evaluations: int | None = None,
    seed_candidates=None,
    greedy=None,
    pareto_eps: float = 0.01,
    n_islands: int | None = None,
    migrate_every: int = 5,
    n_migrants: int | None = None,
    reference: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 3,
    resume: bool = False,
    fault_plan: FaultPlan | None = None,
    retry: RetryPolicy | None = None,
    group=None,
) -> SearchResult:
    """Run the island-model search (the ``engine="sharded"`` path of
    :func:`repro_torch.core.search.evolutionary_search`), on one card or
    over the ranks of a process ``group``.

    The population splits into ``n_islands`` equal islands (default 1;
    ``population_size`` must divide evenly and leave at least 2 rows per
    island), each running the device engine's generation, all in one
    program with an island axis.  Every ``migrate_every`` generations (0
    disables) each island's top ``n_migrants`` rows (default ``local_pop
    // 8``, at least 1) move one island on.  Randomness follows
    :func:`island_keys`; with ``n_islands=1`` the run is bit-identical to
    :func:`evolutionary_search_device`.  Checkpoints use the device
    engine's layout (meta ``engine="sharded"`` with the island geometry,
    which resume validates); ``reference=True`` and demotions run
    :class:`_ShardedHostMirror` (``fail={"sharded": n}`` injects
    failures).

    ``group``: spread the islands over the group's R ranks (``n_islands``
    a multiple of R; each rank passes its own evaluator over the same
    workload, on its device).  Every rank returns the same result, the
    genomes of the one-program run; rank 0 writes the snapshots in the
    one-program layout.  ``reference=True`` raises, and a failed step
    raises on its rank instead of retrying or demoting."""
    return _search(net, profile, evaluator, engine="sharded",
                   population_size=population_size, generations=generations,
                   tournament_k=tournament_k, explore_prob=explore_prob,
                   seed=seed, max_evaluations=max_evaluations,
                   seed_candidates=seed_candidates, greedy=greedy,
                   pareto_eps=pareto_eps, n_islands=n_islands,
                   migrate_every=migrate_every, n_migrants=n_migrants,
                   reference=reference, checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every,
                   checkpoint_keep=checkpoint_keep, resume=resume,
                   fault_plan=fault_plan, retry=retry, group=group)
