"""The port's device-resident search engines (``repro_torch.core.
device_search``) against the JAX package's, on the CPU.

* **decisions**: mutation, nondomination ranks and survival, fed the
  reference's own draws, equal the reference's array programs exactly
  (ties, duplicate phenotypes, dead-tail-only differences, no feasible
  split or merge, a one-layer network, quarantined NaN rows);
* **trajectories**: under one seed, ``engine="device"`` visits the
  reference's jitted engine's genomes in every generation (the
  per-generation snapshots are compared), with objectives within rtol
  1e-9, and lands on its final candidate and front; so does the host
  mirror; the sharded engine with one island is the device engine bit for
  bit, and with two islands (one migration) it steps as the reference's
  ``_ShardedHostMirror``;
* **resilience**: a demotion continues the trajectory, kill-and-resume is
  bit-identical, the port resumes a checkpoint the reference wrote, and
  mismatched engines or island geometries are refused.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _repro_reference import reference
from _torch_workloads import fc_pair
from repro_torch.core import device_search as D
from repro_torch.core import prng
from repro_torch.core import resilience as R
from repro_torch.core.partitioner import SimEvaluator
from repro_torch.core.search import (Population, decode, encode,
                                     evolutionary_search, move_tables,
                                     pareto_ranks, seeded_population)
from repro_torch.neuromorphic import (loihi2_like, minimal_partition,
                                      simulate_population, strided_mapping)

RTOL = 1e-9
SEARCH = dict(population_size=8, generations=5, seed=7)
SIZES = (96, 128, 64)           # the reference suite's fc_workload
KEYS = ("cores", "perm", "stage", "hot_mem", "hot_act")


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.fixture(scope="module")
def work(ref):
    """(reference net, port net, xs, port chip, reference chip, port
    evaluator, reference evaluator) of the reference's fc workload."""
    net_r, net_p, xs = fc_pair(ref, sizes=SIZES, steps=2)
    chip, chip_r = loihi2_like(), ref.platform.loihi2_like()
    return (net_r, net_p, xs, chip, chip_r, SimEvaluator(net_p, xs, chip),
            ref.partitioner.SimEvaluator(net_r, xs, chip_r))


@pytest.fixture(scope="module")
def ref_run(ref, work, tmp_path_factory):
    """The reference's jitted device engine, snapshotting every
    generation."""
    net_r, _, xs, _, chip_r, _, ev_r = work
    d = str(tmp_path_factory.mktemp("ref_device"))
    res = ref.device_search.evolutionary_search_device(
        net_r, chip_r, ev_r, checkpoint_dir=d, checkpoint_keep=100,
        **SEARCH)
    return res, d


def _port_run(work, d=None, **kw):
    _, net_p, xs, chip, _, ev, _ = work
    args = dict(SEARCH, engine="device")
    args.update(kw)
    ev_i = SimEvaluator(net_p, xs, chip, cache=ev.cache)
    res = evolutionary_search(net_p, chip, ev_i,
                              checkpoint_dir=None if d is None else str(d),
                              checkpoint_keep=100, **args)
    return res, ev_i


def _snapshots(d) -> list:
    ck = R.SearchCheckpointer(str(d))
    return [ck.restore(g)[0] for g in range(ck.latest() + 1)]


def _genomes(cands) -> list:
    return [(tuple(c.cores), tuple(c.perm)) for c in cands]


def _assert_same_run(got, want, snaps_got=None, snaps_want=None, *,
                     exact: bool = False):
    """Identical genomes every generation; objectives within rtol 1e-9
    (or equal, ``exact``); the same final candidate and front."""
    close = (lambda a, b: np.array_equal(a, b)) if exact else (
        lambda a, b: np.allclose(a, b, rtol=RTOL, atol=0.0))
    assert len(got.history) == len(want.history)
    for a, b in zip(got.history, want.history):
        assert (a.generation, a.n_evals, a.front_size, a.n_quarantined) \
            == (b.generation, b.n_evals, b.front_size, b.n_quarantined)
        assert close([a.best_time, a.best_energy, a.mean_time],
                     [b.best_time, b.best_energy, b.mean_time])
    assert got.n_evals == want.n_evals
    assert got.seed_best_time == pytest.approx(want.seed_best_time,
                                               rel=RTOL)
    assert _genomes([got.candidate]) == _genomes([want.candidate])
    assert _genomes(got.front) == _genomes(want.front)
    assert close([r.time_per_step for r in got.front_reports],
                 [r.time_per_step for r in want.front_reports])
    if snaps_got is not None:
        assert len(snaps_got) == len(snaps_want)
        for a, b in zip(snaps_got, snaps_want):
            for k in KEYS:
                assert a[k].dtype == b[k].dtype == np.int32, k
                assert np.array_equal(a[k], b[k]), k
            for k in ("times", "energies", "arch_times", "arch_energies"):
                assert close(a[k], b[k]), k
            for k in ("arch_cores", "arch_perm"):
                assert np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------- decisions

def _seed_rows(net, chip, n, seed):
    pop = Population.from_candidates(seeded_population(
        net, chip, size=n, rng=np.random.default_rng(seed)))
    return pop.cores, pop.perm


def _ref_draws(ref, key, **kw):
    with jax.enable_x64():
        return jax.device_get(ref.device_search.generation_draws(key, **kw))


def _torch_draws(d: dict) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


def _mutate_both(ref, cores, perm, stage, hot_mem, hot_act, draws, tables):
    parents = np.asarray(draws["tourn"]).min(axis=1)
    args = (cores[parents], perm[parents], stage[parents], hot_mem[parents],
            hot_act[parents])
    want = ref.device_search.mutate_rows_array(
        np, *args, draws, np.asarray(tables.feasible), tables.n_cores_phys,
        0.25)
    got = D.mutate_rows_array(*(torch.as_tensor(a) for a in args),
                              _torch_draws(draws),
                              torch.as_tensor(tables.feasible),
                              tables.n_cores_phys, 0.25)
    return parents, got, want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mutation_matches_reference(ref, work, seed):
    _, net, _, chip, *_ = work
    tables = move_tables(net, chip)
    cores, perm = _seed_rows(net, chip, 16, seed + 1)
    rng = np.random.default_rng(seed + 2)
    n = cores.shape[0]
    stage = rng.integers(0, 4, n).astype(np.int32)
    hot_mem = rng.integers(0, cores.shape[1], n).astype(np.int32)
    hot_act = rng.integers(0, cores.shape[1], n).astype(np.int32)
    draws = _ref_draws(ref, jax.random.PRNGKey(seed), n_off=n, n_pop=n,
                       n_layers=cores.shape[1], n_slots=perm.shape[1],
                       tournament_k=3)
    parents, (c, p), (cw, pw) = _mutate_both(ref, cores, perm, stage,
                                             hot_mem, hot_act, draws, tables)
    assert c.dtype == p.dtype == torch.int32
    assert np.array_equal(c.numpy(), cw) and np.array_equal(p.numpy(), pw)
    for k in range(n):              # every offspring valid and changed
        i = int(parents[k])
        assert not (np.array_equal(cw[k], cores[i])
                    and np.array_equal(pw[k], perm[i]))
        assert tables.valid_rows(cw[k][None, :])[0]
        assert sorted(pw[k]) == list(range(chip.n_cores))


@pytest.mark.parametrize("case", ["no_split_or_merge", "one_layer",
                                  "tied_priorities", "full_chip"])
def test_mutation_edge_cases_match_reference(ref, case):
    sizes = (64, 32) if case == "one_layer" else (48, 32, 16)
    net_r, net, _ = fc_pair(ref, sizes=sizes, steps=2)
    chip = loihi2_like()
    if case == "no_split_or_merge":       # every row pinned at one core
        chip = dataclasses.replace(chip, allow_partitioning=False)
    tables = move_tables(net, chip)
    cores, perm = _seed_rows(net, chip, 8, 3)
    n, L = cores.shape
    if case == "full_chip":               # no room for a split anywhere
        cores[:, 0] += chip.n_cores - cores.sum(axis=1)
    stage = np.arange(n, dtype=np.int32) % 4
    zeros = np.zeros(n, np.int32)
    draws = _ref_draws(ref, jax.random.PRNGKey(5), n_off=n, n_pop=n,
                       n_layers=L, n_slots=perm.shape[1], tournament_k=2)
    if case == "tied_priorities":         # every argmax is a tie
        draws["split_pri"] = np.full((n, L), 0.5)
        draws["merge_pri"] = np.full((n, L), 0.5)
        draws["explore_u"] = np.ones(n)
    _, (c, p), (cw, pw) = _mutate_both(ref, cores, perm, stage, zeros,
                                       zeros + L - 1, draws, tables)
    assert np.array_equal(c.numpy(), cw) and np.array_equal(p.numpy(), pw)
    if case in ("no_split_or_merge", "full_chip"):
        assert (cw.sum(axis=1) <= chip.n_cores).all()
    if case == "no_split_or_merge":
        assert (cw == 1).all()


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 300), cap=st.integers(1, 24))
def test_pareto_ranks_match_reference(ref, seed, cap):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 24))
    # a tiny integer grid: many exact duplicates and dominance ties
    t = rng.integers(0, 4, k).astype(np.float64)
    e = rng.integers(0, 4, k).astype(np.float64)
    tt, et = torch.as_tensor(t), torch.as_tensor(e)
    for n_keep in (None, cap):
        want = ref.search.pareto_ranks(t, e, n_keep)
        with jax.enable_x64():
            want_j = np.asarray(ref.device_search.pareto_ranks_array(
                jax.numpy.asarray(t), jax.numpy.asarray(e), n_keep=n_keep))
        got = D.pareto_ranks_array(tt, et, n_keep)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(want_j, want)
        assert np.array_equal(pareto_ranks(t, e, n_keep), want)
    # islands along a leading axis rank as each island alone
    t2, e2 = torch.stack([tt, tt.flip(0)]), torch.stack([et, et * 2])
    both = D.pareto_ranks_array(t2, e2, cap)
    for i in range(2):
        assert torch.equal(both[i], D.pareto_ranks_array(t2[i], e2[i], cap))


def test_pareto_ranks_known_points():
    r = D.pareto_ranks_array(torch.tensor([1.0, 2.0, 3.0, 2.0]),
                             torch.tensor([3.0, 1.0, 2.0, 2.0]))
    assert r.tolist() == [0, 0, 2, 1]


def _survival_case(net, chip, case, seed):
    cores, perm = _seed_rows(net, chip, 12, seed)
    rng = np.random.default_rng(seed)
    t = rng.uniform(1, 10, 12)
    e = rng.uniform(1, 10, 12)
    if case in ("duplicates", "dead_tail"):
        cores[3], perm[3] = cores[0], perm[0]
        t[3], e[3] = t[0], e[0]
        cores[7], perm[7] = cores[1], perm[1].copy()
        t[7], e[7] = t[1], e[1]
        if case == "dead_tail":         # same phenotype, other genome bytes
            n = int(cores[7].sum())
            perm[7, n:] = perm[7, n:][::-1]
    elif case == "all_one_phenotype":   # fewer unique rows than survivors
        cores[:], perm[:] = cores[0], perm[0]
        t[:], e[:] = t[0], e[0]
    elif case == "tied_objectives":
        t = np.round(t / 3)
        e = np.round(e / 3)
    return cores, perm, t, e


@pytest.mark.parametrize("case", ["distinct", "duplicates", "dead_tail",
                                  "all_one_phenotype", "tied_objectives"])
@pytest.mark.parametrize("n_keep", [6, 12])
def test_survival_order_matches_reference(ref, work, case, n_keep):
    _, net, _, chip, *_ = work
    cores, perm, t, e = _survival_case(net, chip, case, 4)
    ranks = ref.search.pareto_ranks(t, e, n_keep)
    want = ref.device_search.survival_order_array(np, cores, perm, t, e,
                                                  ranks, n_keep)
    args = [torch.as_tensor(a) for a in (cores, perm, t, e, ranks)]
    got = D.survival_order_array(*args, n_keep)
    assert np.array_equal(got.numpy(), want)
    bound = D.survival_order_array(*args, n_keep,
                                   gene_max=chip.n_cores + 1)
    assert np.array_equal(bound.numpy(), want)
    keys = {Population.row_key(cores[i], perm[i]) for i in want}
    n_unique = len({Population.row_key(c, p) for c, p in zip(cores, perm)})
    assert len(keys) == min(n_keep, n_unique)
    # two islands sort as each island alone
    c2 = torch.stack([args[0], args[0].flip(0)])
    p2 = torch.stack([args[1], args[1].flip(0)])
    tt, ee, rr = (torch.stack([a, a.flip(0)]) for a in args[2:])
    two = D._survival_order(c2, p2, tt, ee, rr, n_keep)
    for i in range(2):
        alone = D.survival_order_array(c2[i], p2[i], tt[i], ee[i], rr[i],
                                       n_keep)
        assert torch.equal(two[i], alone)


def test_nan_rows_are_quarantined_as_the_reference(ref, work):
    _, net, _, chip, *_ = work
    cores, perm = _seed_rows(net, chip, 10, 6)
    rng = np.random.default_rng(6)
    t, e = rng.uniform(1, 10, 10), rng.uniform(1, 10, 10)
    t[[1, 4]] = np.nan
    e[6] = np.inf
    out = dict(times=t, energies=e,
               stage=rng.integers(0, 4, 10).astype(np.int32),
               hot_mem=np.zeros(10, np.int32), hot_act=np.ones(10, np.int32))
    want = ref.device_search._sorted_state(np, ref.search.pareto_ranks,
                                           cores, perm, out, 9)
    got = D._sorted_state(torch.as_tensor(cores), torch.as_tensor(perm),
                          {k: torch.as_tensor(v) for k, v in out.items()}, 9)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
    # the bad rows sort last, with the sentinel fitness
    assert np.isinf(want["times"][-2:]).all()
    assert np.isfinite(want["times"][:-2]).all()


# ---------------------------------------------------------- trajectories

def test_device_run_matches_reference(ref, work, ref_run, tmp_path):
    want, d_r = ref_run
    got, ev = _port_run(work, tmp_path)
    _assert_same_run(got, want, _snapshots(tmp_path), _snapshots(d_r))
    assert got.demotions == [] and ev.n_evals == got.n_evals
    tel = got.telemetry
    assert len(tel["peel_iterations"]) == len(tel["host_syncs"]) \
        == SEARCH["generations"] + 1
    # each generation reads one flag per front plus the last test, one
    # stats-and-offspring transfer and one snapshot
    for peel, syncs in zip(tel["peel_iterations"][1:],
                           tel["host_syncs"][1:]):
        assert peel >= 1 and syncs == peel + 3
    assert set(tel["stage_s"]) == set(D.SearchTelemetry.STAGES)


def test_host_mirror_matches_reference(ref, work, ref_run, tmp_path):
    want, d_r = ref_run
    got, _ = _port_run(work, tmp_path, reference=True)
    _assert_same_run(got, want, _snapshots(tmp_path), _snapshots(d_r))


def test_device_run_is_deterministic(work):
    a, _ = _port_run(work)
    b, _ = _port_run(work)
    _assert_same_run(a, b, exact=True)


def test_budget_and_seeds(ref, work):
    """A ``max_evaluations`` budget truncates the seeds and the last
    generation as the reference does; explicit seed candidates are
    used as given."""
    net_r, net, xs, chip, chip_r, ev, ev_r = work
    kw = dict(population_size=6, generations=4, seed=11, max_evaluations=20)
    got, ev_i = _port_run(work, **kw)
    want = ref.device_search.evolutionary_search_device(
        net_r, chip_r, ref.partitioner.SimEvaluator(net_r, xs, chip_r,
                                                    cache=ev_r.cache), **kw)
    _assert_same_run(got, want)
    assert got.n_evals == ev_i.n_evals <= 20
    p0 = minimal_partition(net, chip)
    same = [encode(p0, strided_mapping(p0, chip), chip.n_cores)] * 6
    dup, _ = _port_run(work, population_size=6, generations=2,
                       seed_candidates=same)
    assert len(set(_genomes(dup.front))) == len(dup.front)
    assert dup.report.time_per_step <= dup.seed_best_time * (1 + 1e-12)


def test_sharded_one_island_is_the_device_engine(ref, work, ref_run,
                                                 tmp_path):
    want, d_r = ref_run
    dev, _ = _port_run(work, tmp_path / "device")
    one, _ = _port_run(work, tmp_path / "sharded", engine="sharded",
                       n_islands=1)
    snaps = _snapshots(tmp_path / "sharded")
    _assert_same_run(one, dev, snaps, _snapshots(tmp_path / "device"),
                     exact=True)
    net_r, _, xs, _, chip_r, _, ev_r = work
    ref_one = ref.device_search.evolutionary_search_sharded(
        net_r, chip_r, ref.partitioner.SimEvaluator(net_r, xs, chip_r,
                                                    cache=ev_r.cache),
        n_islands=1, **SEARCH)
    _assert_same_run(one, ref_one, snaps, _snapshots(d_r))


def _island_setup(ref, work, n_islands=2, local=4, n_migrants=1):
    net_r, net, xs, chip, chip_r, ev, ev_r = work
    tables, tables_r = move_tables(net, chip), ref.search.move_tables(
        net_r, chip_r)
    geo = dict(n_islands=n_islands, local_pop=local, n_migrants=n_migrants,
               explore_prob=0.25, tournament_k=3)
    eng = D.ShardedSearchEngine(net, chip, ev.cache, tables, **geo)
    mirror = D._ShardedHostMirror(net, xs, chip, ev.cache, tables, **geo)
    mirror_r = ref.device_search._ShardedHostMirror(
        net_r, xs, chip_r, ev_r.cache, tables_r, **geo)
    cores, perm = _seed_rows(net, chip, n_islands * local, 8)
    return eng, mirror, mirror_r, cores, perm


def _states_equal(got: dict, want: dict, keys=KEYS) -> None:
    for k in keys:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    for k in ("times", "energies"):
        assert np.allclose(np.asarray(got[k]), np.asarray(want[k]),
                           rtol=RTOL, atol=0.0), k


def test_two_islands_step_as_the_reference_host_mirror(ref, work):
    eng, mirror, mirror_r, cores, perm = _island_setup(ref, work)
    s, _ = eng.init(cores, perm)
    m, _ = mirror.init(cores, perm)
    w, _ = mirror_r.init(cores, perm)
    _states_equal(s, w)
    _states_equal(m, w)
    base, base_r = prng.PRNGKey(3), jax.random.PRNGKey(3)
    for gen, migrate in ((1, False), (2, True), (3, False)):
        keys = D.island_keys(base, gen, 2)
        s, off, st = eng.step(s, keys, 4, migrate)
        m, off_m, st_m = mirror.step(m, keys, 4, migrate)
        w, off_w, st_w = mirror_r.step(
            w, ref.device_search.island_keys(base_r, gen, 2), 4, migrate)
        for got in (s, m):
            _states_equal(got, w)
        for o in (off, off_m):
            _states_equal(o, off_w, keys=("cores", "perm"))
        for stats in (st, st_m):
            assert np.allclose([float(stats[k]) for k in (
                "best_time", "best_energy", "mean_time")],
                [float(st_w[k][0]) for k in (
                    "best_time", "best_energy", "mean_time")], rtol=RTOL)
            assert int(stats["n_quarantined"]) == int(
                st_w["n_quarantined"][0])


def test_migration_rotates_elites_and_keeps_the_multiset(ref, work):
    eng, mirror, mirror_r, cores, perm = _island_setup(
        ref, work, n_islands=3, local=4, n_migrants=2)
    s, _ = eng.init(cores, perm)
    moved = eng.migrate(s)
    _states_equal(moved, mirror_r.migrate(mirror_r.init(cores, perm)[0]))
    _states_equal(mirror.migrate(s), moved)
    rows = lambda st: sorted(map(tuple, np.concatenate(
        [st["cores"].numpy(), st["perm"].numpy()], axis=1).tolist()))
    assert rows(moved) == rows(s)


def test_sharded_runs_match_the_host_mirror(work):
    kw = dict(engine="sharded", n_islands=2, migrate_every=2,
              population_size=8, generations=4, seed=3)
    got, _ = _port_run(work, **kw)
    mir, _ = _port_run(work, reference=True, **kw)
    _assert_same_run(got, mir)


# ------------------------------------------------------------ resilience

@pytest.mark.parametrize("engine", ["device", "sharded"])
def test_scripted_failure_demotes_and_continues(work, engine):
    kw = dict(engine=engine)
    if engine == "sharded":
        kw.update(n_islands=2, migrate_every=2)
    want, _ = _port_run(work, **kw)
    got, _ = _port_run(work, fault_plan=R.FaultPlan(fail={engine: 2}), **kw)
    assert [(d.frm, d.to, d.site) for d in got.demotions] \
        == [(engine, "numpy-mirror", "init")]
    _assert_same_run(got, want)


class _FailsOnStep(D.DeviceSearchEngine):
    """A device engine whose third step onwards raises."""

    def step(self, *a, **kw):
        self.steps = getattr(self, "steps", 0) + 1
        if self.steps >= 3:
            raise RuntimeError("device lost")
        return super().step(*a, **kw)


def test_mid_run_demotion_continues_the_trajectory(work, monkeypatch):
    _, net, xs, chip, _, ev, _ = work
    want, _ = _port_run(work)
    sleeps = []
    monkeypatch.setattr(D.time, "sleep", sleeps.append)

    def engine_for(net_, chip_, cache, tables, **kw):
        return _FailsOnStep(net_, chip_, cache, tables,
                            explore_prob=kw["explore_prob"],
                            tournament_k=kw["tournament_k"])
    monkeypatch.setattr(D, "_engine_for", engine_for)
    retry = R.RetryPolicy(max_retries=2, backoff_s=0.5, multiplier=3.0)
    got, _ = _port_run(work, retry=retry)
    assert [(d.frm, d.to, d.site, d.retries) for d in got.demotions] \
        == [("device", "numpy-mirror", "step", 2)]
    assert sleeps == [0.5, 1.5]
    _assert_same_run(got, want)
    # a permanent outage (ALWAYS) demotes once, at init
    res, _ = _port_run(work, fault_plan=R.FaultPlan(
        fail={"device": R.ALWAYS}))
    assert len(res.demotions) == 1
    _assert_same_run(res, want)


def test_mirror_nan_rows_match_reference(ref, work):
    net_r, _, xs, _, chip_r, _, ev_r = work
    plan = dict(nan_rows={0: [1], 2: [0, 3]})
    got, _ = _port_run(work, reference=True, fault_plan=R.FaultPlan(**plan))
    want = ref.device_search.evolutionary_search_device(
        net_r, chip_r, ref.partitioner.SimEvaluator(net_r, xs, chip_r,
                                                    cache=ev_r.cache),
        reference=True, fault_plan=ref.resilience.FaultPlan(**plan),
        **SEARCH)
    _assert_same_run(got, want)
    assert [g.n_quarantined for g in got.history][:3] == [0, 0, 2]


@pytest.mark.parametrize("engine", ["device", "sharded"])
def test_kill_and_resume_is_bit_identical(work, tmp_path, engine):
    kw = dict(engine=engine)
    if engine == "sharded":
        kw.update(n_islands=2, migrate_every=2)
    full, _ = _port_run(work, tmp_path / "full", **kw)
    with pytest.raises(R.SimulatedCrash):
        _port_run(work, tmp_path / "k", checkpoint_every=2,
                  fault_plan=R.FaultPlan(kill_after_gen=2), **kw)
    assert R.SearchCheckpointer(str(tmp_path / "k")).latest() == 2
    res, ev = _port_run(work, tmp_path / "k", resume=True, **kw)
    _assert_same_run(res, full, exact=True)
    assert ev.n_evals == 3 * 8                      # generations 3 to 5
    a = R.SearchCheckpointer(str(tmp_path / "k")).restore()[0]
    b = R.SearchCheckpointer(str(tmp_path / "full")).restore()[0]
    assert all(np.array_equal(a[k], b[k]) for k in b)


def test_port_resumes_a_checkpoint_the_reference_wrote(ref, work, ref_run,
                                                       tmp_path):
    want, _ = ref_run
    net_r, _, xs, _, chip_r, _, ev_r = work
    d = str(tmp_path / "ck")
    with pytest.raises(ref.resilience.SimulatedCrash):
        ref.device_search.evolutionary_search_device(
            net_r, chip_r, ref.partitioner.SimEvaluator(net_r, xs, chip_r,
                                                        cache=ev_r.cache),
            checkpoint_dir=d,
            fault_plan=ref.resilience.FaultPlan(kill_after_gen=2), **SEARCH)
    got, _ = _port_run(work, d, resume=True)
    _assert_same_run(got, want)


def test_resume_refuses_another_engine_or_geometry(work, tmp_path):
    d = tmp_path / "sharded"
    _port_run(work, d, engine="sharded", n_islands=2, generations=1)
    with pytest.raises(ValueError, match="'sharded' engine"):
        _port_run(work, d, resume=True)
    for bad in (dict(n_islands=4), dict(n_migrants=2),
                dict(migrate_every=3), dict(population_size=12)):
        kw = dict(engine="sharded", n_islands=2, generations=1)
        kw.update(bad)
        with pytest.raises(ValueError, match="written with"):
            _port_run(work, d, resume=True, **kw)
    _port_run(work, tmp_path / "numpy", engine="numpy", generations=1)
    with pytest.raises(ValueError, match="'numpy' engine"):
        _port_run(work, tmp_path / "numpy", resume=True)


def test_arguments_are_validated(work):
    _, net, xs, chip, _, ev, _ = work
    with pytest.raises(TypeError, match="SimEvaluator-like"):
        evolutionary_search(net, chip, lambda p, m: ev(p, m),
                            engine="device", population_size=4)
    for kw, msg in ((dict(population_size=10, n_islands=4), "divide"),
                    (dict(population_size=4, n_islands=4), "at least 2"),
                    (dict(n_islands=2, n_migrants=5), "n_migrants"),
                    (dict(n_islands=2, n_migrants=0), "n_migrants")):
        with pytest.raises(ValueError, match=msg):
            _port_run(work, engine="sharded", **kw)
    p0 = minimal_partition(net, chip)
    with pytest.raises(ValueError, match="fill"):
        _port_run(work, engine="sharded", seed_candidates=[
            encode(p0, strided_mapping(p0, chip), chip.n_cores)])
    with pytest.raises(ValueError, match="reference= and retry="):
        _port_run(work, engine="numpy", reference=True)


# --------------------------------------------------------------- pricing

@pytest.mark.parametrize("n_islands", [1, 3])
def test_sharded_population_backend_matches_device(work, n_islands):
    _, net, xs, chip, _, ev, _ = work
    cores, perm = _seed_rows(net, chip, 7, 9)
    pairs = Population(cores, perm).pairs()
    dev = simulate_population(net, xs, chip, pairs, cache=ev.cache,
                              backend="device")
    if n_islands == 1:
        sh = simulate_population(net, xs, chip, pairs, cache=ev.cache,
                                 backend="sharded")
    else:                   # 7 rows over 3 islands: two padding rows
        from repro_torch.neuromorphic import price_population_sharded
        sh = price_population_sharded(net, chip, ev.cache, cores, perm,
                                      n_islands=n_islands)
    assert len(sh) == len(dev) == 7
    for a, b in zip(sh, dev):
        assert a.bottleneck_stage == b.bottleneck_stage
        assert a.n_cores_active == b.n_cores_active
        assert np.allclose([a.time_per_step, a.energy_per_step],
                           [b.time_per_step, b.energy_per_step],
                           rtol=RTOL, atol=0.0)
        assert torch.allclose(a.per_core_synops, b.per_core_synops,
                              rtol=RTOL, atol=0.0)


def test_device_pricer_stage_and_hot_layers_match_reference(ref, work):
    net_r, net, _, chip, chip_r, ev, ev_r = work
    cores, perm = _seed_rows(net, chip, 12, 10)
    want = ref.timestep.device_pricer(net_r, chip_r, ev_r.cache).price(
        cores, perm)
    got = D.device_pricer(net, chip, ev.cache).price(
        torch.as_tensor(cores).long(), torch.as_tensor(perm).long())
    for k in ("stage", "hot_mem", "hot_act"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert np.allclose(got["time_per_step"].numpy(), want["time_per_step"],
                       rtol=RTOL, atol=0.0)
    reports = simulate_population(net, None, chip, [decode(c) for c in
                                  Population(cores, perm).candidates()],
                                  cache=ev.cache)
    assert [D.STAGE_ID[r.bottleneck_stage] for r in reports] \
        == got["stage"].tolist()
