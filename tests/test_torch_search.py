"""The port's evolutionary mapping search against the JAX package's host
``"numpy"`` engine, on the CPU.

Both packages draw from the same numpy generator in the same order, so
under one seed they must visit the same genomes every generation: each
run snapshots every generation (``checkpoint_dir``), and the snapshots
are compared genome for genome, phenotype set for phenotype set and
archive for archive; objectives agree to rtol 1e-9 (the float64 pricing
contract).  Both port population backends are held to it.  Within the
port, kill-and-resume is bit-identical, and a run the reference kills
resumes in the port to the reference's result.
"""

import os

import numpy as np
import pytest

from _repro_reference import reference
from _torch_workloads import conv_pair, fc_pair
from repro_torch.core import resilience as R
from repro_torch.core.partitioner import SimEvaluator, optimize_partitioning
from repro_torch.core.search import (Candidate, EpsParetoArchive, Population,
                                     decode, decode_population, encode,
                                     encode_population, evolutionary_search,
                                     greedy_then_evolve, knee_point,
                                     move_tables, mutate, pareto_ranks,
                                     seeded_population)
from repro_torch.neuromorphic import (loihi2_like, minimal_partition,
                                      ordered_mapping, random_mapping,
                                      strided_mapping)
from repro_torch.neuromorphic.platform import speck_like

RTOL = 1e-9
WORKLOADS = {"fc": fc_pair, "conv": conv_pair}


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _genome(c) -> tuple:
    return (tuple(c.cores), tuple(c.perm))


# ------------------------------------------------------------- genomes

@pytest.mark.parametrize("kind", ["fc", "conv"])
def test_encoding_and_population_ops_match_reference(ref, kind):
    net_r, net_p, _ = WORKLOADS[kind](ref)
    chip = loihi2_like()
    rng = np.random.default_rng(0)
    p0 = minimal_partition(net_p, chip)
    parts = [p0, p0.split(0).split(0), p0.split(len(p0.cores) - 1)]
    cands, cands_r = [], []
    for part in parts:
        for mk in (ordered_mapping, strided_mapping,
                   lambda p, pr: random_mapping(p, pr, rng)):
            m = mk(part, chip)
            c = encode(part, m, chip.n_cores)
            c_r = ref.search.encode(ref.partition.Partition(part.cores),
                                    ref.noc.Mapping(m.phys), chip.n_cores)
            assert _genome(c) == _genome(c_r)
            p2, m2 = decode(c)
            assert p2 == part and tuple(m2.phys) == tuple(m.phys)
            assert m2.name == "evolved" and c.n_logical == part.total_cores
            cands.append(c)
            cands_r.append(c_r)
    cores, perm = encode_population(cands)
    cores_r, perm_r = ref.search.encode_population(cands_r)
    assert np.array_equal(cores, cores_r) and np.array_equal(perm, perm_r)
    assert cores.dtype == perm.dtype == np.int32
    assert [_genome(c) for c in decode_population(cores, perm)] \
        == [_genome(c) for c in cands]
    pop, pop_r = Population(cores, perm), ref.search.Population(cores, perm)
    assert [pop.phenotype(k) for k in range(len(pop))] \
        == [pop_r.phenotype(k) for k in range(len(pop_r))]
    idx = np.array([4, 0, 2])
    both = Population.concatenate(pop.take(idx), pop)
    both_r = ref.search.Population.concatenate(pop_r.take(idx), pop_r)
    assert np.array_equal(both.cores, both_r.cores)
    assert np.array_equal(both.perm, both_r.perm)
    assert [(tuple(p.cores), tuple(m.phys)) for p, m in pop.pairs()] \
        == [(tuple(p.cores), tuple(m.phys)) for p, m in pop_r.pairs()]
    # the unexpressed tail does not enter the phenotype
    tail = perm.copy()
    n = int(cores[0].sum())
    tail[0, n:] = tail[0, n:][::-1]
    assert Population.row_key(cores[0], tail[0]) == pop.phenotype(0)


@pytest.mark.parametrize("kind", ["fc", "conv"])
@pytest.mark.parametrize("chip", ["loihi2", "speck"])
def test_move_tables_match_reference(ref, kind, chip):
    net_r, net_p, _ = WORKLOADS[kind](ref)
    prof = {"loihi2": loihi2_like, "speck": speck_like}[chip]()
    prof_r = getattr(ref.platform, f"{chip}_like")()
    t, t_r = move_tables(net_p, prof), ref.search.move_tables(net_r, prof_r)
    assert np.array_equal(t.feasible, t_r.feasible)
    assert t.n_cores_phys == t_r.n_cores_phys
    rows = np.random.default_rng(1).integers(0, 6, (40, len(net_p.layers)))
    assert np.array_equal(t.valid_rows(rows), t_r.valid_rows(rows))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fronts_and_archive_match_reference(ref, seed):
    rng = np.random.default_rng(seed)
    t = np.round(rng.random(40) * 8) / 8          # ties on purpose
    e = np.round(rng.random(40) * 8) / 8
    for n_keep in (None, 1, 7, 40):
        assert np.array_equal(pareto_ranks(t, e, n_keep),
                              ref.search.pareto_ranks(t, e, n_keep))
    assert knee_point(t, e) == ref.search.knee_point(t, e)
    assert knee_point([1.0], [2.0]) == 0
    cores = rng.integers(1, 4, (40, 3)).astype(np.int32)
    perm = np.stack([rng.permutation(12) for _ in range(40)]).astype(np.int32)
    t2, e2 = t.copy(), e.copy()
    t2[3], e2[5] = np.nan, np.inf
    a, a_r = EpsParetoArchive(0.05), ref.search.EpsParetoArchive(0.05)
    for lo, hi in ((0, 15), (15, 40)):
        got = a.update_batch(t2[lo:hi], e2[lo:hi], cores[lo:hi],
                             perm[lo:hi])
        assert got == a_r.update_batch(t2[lo:hi], e2[lo:hi], cores[lo:hi],
                                       perm[lo:hi])
    st, st_r = a.state_arrays(3, 12), a_r.state_arrays(3, 12)
    for k in st:
        assert np.array_equal(st[k], st_r[k]), k
    assert [_genome(c) for c in a.front()[0]] \
        == [_genome(c) for c in a_r.front()[0]]
    b = EpsParetoArchive(0.05)
    b.load_state(st_r)
    assert len(b) == len(a)
    b.add(0.0, 0.0, cores[0], perm[0], None)        # dominates everything
    assert len(b) == 1
    assert not b.add(float("nan"), 0.0, cores[0], perm[0], None)
    empty = EpsParetoArchive().state_arrays(3, 12)
    assert empty["arch_cores"].shape == (0, 3)


@pytest.mark.parametrize("kind", ["fc", "conv"])
def test_seeding_and_mutation_match_reference(ref, kind):
    net_r, net_p, xs = WORKLOADS[kind](ref)
    chip, chip_r = loihi2_like(), ref.platform.loihi2_like()
    ev = SimEvaluator(net_p, xs, chip)
    ev_r = ref.partitioner.SimEvaluator(net_r, xs, chip_r)
    greedy = optimize_partitioning(net_p, chip, ev)
    greedy_r = ref.partitioner.optimize_partitioning(net_r, chip_r, ev_r)
    for size in (3, 20):
        for g, g_r in ((None, None), (greedy, greedy_r)):
            rng, rng_r = np.random.default_rng(5), np.random.default_rng(5)
            got = seeded_population(net_p, chip, size=size, rng=rng,
                                    greedy=g)
            want = ref.search.seeded_population(net_r, chip_r, size=size,
                                                rng=rng_r, greedy=g_r)
            assert [_genome(c) for c in got] == [_genome(c) for c in want]
            assert rng.random() == rng_r.random()
    cands = seeded_population(net_p, chip, size=12,
                              rng=np.random.default_rng(2), greedy=greedy)
    pairs = [decode(c) for c in cands]
    reps = ev.evaluate_population(pairs)
    reps_r = ev_r.evaluate_population(
        [(ref.partition.Partition(p.cores), ref.noc.Mapping(m.phys))
         for p, m in pairs])
    rng, rng_r = np.random.default_rng(9), np.random.default_rng(9)
    tables = move_tables(net_p, chip)
    for _ in range(3):
        for c, r, r_r in zip(cands, reps, reps_r):
            assert r.bottleneck_stage == r_r.bottleneck_stage
            for explore in (0.0, 0.25, 1.0):
                m = mutate(c, r, net_p, chip, rng, explore_prob=explore,
                           tables=tables)
                m_r = ref.search.mutate(ref.search.Candidate(*_genome(c)),
                                        r_r, net_r, chip_r, rng_r,
                                        explore_prob=explore)
                assert _genome(m) == _genome(m_r)
                assert m != c and tables.valid_rows(
                    np.asarray([m.cores]))[0]


# --------------------------------------------------------------- search

def _snapshots(d: str) -> dict:
    """{generation: (arrays, meta)} of every snapshot in ``d``."""
    cp = R.SearchCheckpointer(d)
    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith("step_"):
            arrays, gen, meta = cp.restore(int(f[5:-4]))
            out[gen] = (arrays, meta)
    return out


def _assert_snapshots_match(got: dict, want: dict, exact_objectives: bool):
    assert sorted(got) == sorted(want)
    for gen in want:
        (a, m), (b, n) = got[gen], want[gen]
        for k in ("cores", "perm", "tried_buf", "tried_lens", "arch_cores",
                  "arch_perm"):
            assert np.array_equal(a[k], b[k]), (gen, k)
        for k in ("times", "energies", "arch_times", "arch_energies"):
            if exact_objectives:
                assert np.array_equal(a[k], b[k]), (gen, k)
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL,
                                           err_msg=f"gen {gen} {k}")
        assert m["rng_state"] == n["rng_state"], gen
        assert m["evals_used"] == n["evals_used"]
        assert [h["n_evals"] for h in m["history"]] \
            == [h["n_evals"] for h in n["history"]]


def _assert_results_match(got, want, exact_objectives: bool):
    assert _genome(got.candidate) == _genome(want.candidate)
    assert [_genome(c) for c in got.front] == [_genome(c) for c in want.front]
    assert got.n_evals == want.n_evals
    assert len(got.history) == len(want.history)
    for g, w in zip(got.history, want.history):
        assert (g.generation, g.n_evals, g.front_size, g.n_quarantined) \
            == (w.generation, w.n_evals, w.front_size, w.n_quarantined)
        for f in ("best_time", "best_energy", "mean_time"):
            if exact_objectives:
                assert getattr(g, f) == getattr(w, f), f
            else:
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=RTOL, err_msg=f)
    tol = 0.0 if exact_objectives else RTOL
    np.testing.assert_allclose(got.seed_best_time, want.seed_best_time,
                               rtol=tol)
    np.testing.assert_allclose(
        [r.time_per_step for r in got.front_reports],
        [r.time_per_step for r in want.front_reports], rtol=tol)
    kg, kw = got.knee(), want.knee()
    assert _genome(kg[0]) == _genome(kw[0])


SEARCH = dict(population_size=12, generations=5, seed=3)


@pytest.mark.parametrize("backend", ["numpy", "device"])
@pytest.mark.parametrize("kind", ["fc", "conv"])
def test_search_visits_reference_genomes_every_generation(ref, tmp_path,
                                                          kind, backend):
    net_r, net_p, xs = WORKLOADS[kind](ref)
    chip, chip_r = loihi2_like(), ref.platform.loihi2_like()
    plan = dict(nan_rows={2: (1, 4)})             # quarantine in gen 2
    got = evolutionary_search(
        net_p, chip, SimEvaluator(net_p, xs, chip,
                                  population_backend=backend,
                                  fallback=False),
        checkpoint_dir=str(tmp_path / "p"), checkpoint_keep=100,
        fault_plan=R.FaultPlan(**plan), **SEARCH)
    want = ref.search.evolutionary_search(
        net_r, chip_r, ref.partitioner.SimEvaluator(net_r, xs, chip_r),
        checkpoint_dir=str(tmp_path / "r"), checkpoint_keep=100,
        fault_plan=ref.resilience.FaultPlan(**plan), **SEARCH)
    assert want.history[2].n_quarantined == 2
    _assert_results_match(got, want, exact_objectives=False)
    _assert_snapshots_match(_snapshots(str(tmp_path / "p")),
                            _snapshots(str(tmp_path / "r")),
                            exact_objectives=False)
    assert got.demotions == []


@pytest.mark.parametrize("kind", ["fc", "conv"])
def test_greedy_then_evolve_matches_reference(ref, kind):
    net_r, net_p, xs = WORKLOADS[kind](ref)
    chip, chip_r = loihi2_like(), ref.platform.loihi2_like()
    ev = SimEvaluator(net_p, xs, chip, population_backend="device",
                      fallback=False)
    ev_r = ref.partitioner.SimEvaluator(net_r, xs, chip_r)
    g, e = greedy_then_evolve(net_p, chip, ev, population_size=10,
                              generations=4, seed=1, max_evaluations=40)
    g_r, e_r = ref.search.greedy_then_evolve(net_r, chip_r, ev_r,
                                             population_size=10,
                                             generations=4, seed=1,
                                             max_evaluations=40)
    assert tuple(g.partition.cores) == tuple(g_r.partition.cores)
    assert tuple(g.mapping.phys) == tuple(g_r.mapping.phys)
    assert [(s.move, s.accepted) for s in g.history] \
        == [(s.move, s.accepted) for s in g_r.history]
    _assert_results_match(e, e_r, exact_objectives=False)
    assert ev.n_evals == ev_r.n_evals
    assert ev.demotions == [] and ev.active_backend == "device"
    assert e.report.time_per_step <= g.report.time_per_step
    assert e.history[-1].n_evals <= 40


@pytest.mark.parametrize("kind", ["fc", "conv"])
def test_kill_and_resume_is_bit_identical(ref, tmp_path, kind):
    _, net, xs = WORKLOADS[kind](ref)
    chip = loihi2_like()
    ev = SimEvaluator(net, xs, chip)
    full = evolutionary_search(net, chip, ev, **SEARCH)
    d = str(tmp_path / "ck")
    ev2 = SimEvaluator(net, xs, chip, cache=ev.cache)
    with pytest.raises(R.SimulatedCrash):
        evolutionary_search(net, chip, ev2, checkpoint_dir=d,
                            fault_plan=R.FaultPlan(kill_after_gen=2),
                            **SEARCH)
    assert R.SearchCheckpointer(d).latest() == 2
    ev3 = SimEvaluator(net, xs, chip, cache=ev.cache)
    resumed = evolutionary_search(net, chip, ev3, checkpoint_dir=d,
                                  resume=True, **SEARCH)
    _assert_results_match(resumed, full, exact_objectives=True)
    assert ev3.n_evals < ev.n_evals                 # gens 3..5 only
    # resuming a finished run is a no-op that returns the same result
    again = evolutionary_search(net, chip, SimEvaluator(
        net, xs, chip, cache=ev.cache), checkpoint_dir=d, resume=True,
        **SEARCH)
    _assert_results_match(again, full, exact_objectives=True)


def test_port_resumes_a_run_the_reference_killed(ref, tmp_path):
    net_r, net_p, xs = fc_pair(ref)
    chip, chip_r = loihi2_like(), ref.platform.loihi2_like()
    want = ref.search.evolutionary_search(
        net_r, chip_r, ref.partitioner.SimEvaluator(net_r, xs, chip_r),
        **SEARCH)
    d = str(tmp_path / "ck")
    with pytest.raises(ref.resilience.SimulatedCrash):
        ref.search.evolutionary_search(
            net_r, chip_r, ref.partitioner.SimEvaluator(net_r, xs, chip_r),
            checkpoint_dir=d,
            fault_plan=ref.resilience.FaultPlan(kill_after_gen=2), **SEARCH)
    got = evolutionary_search(net_p, chip, SimEvaluator(net_p, xs, chip),
                              checkpoint_dir=d, resume=True, **SEARCH)
    _assert_results_match(got, want, exact_objectives=False)


def test_engines_and_arguments_are_validated(ref, tmp_path):
    _, net, xs = fc_pair(ref)
    chip = loihi2_like()
    ev = SimEvaluator(net, xs, chip)
    for engine in ("device", "sharded"):
        with pytest.raises(NotImplementedError, match="device_search"):
            evolutionary_search(net, chip, ev, engine=engine)
    with pytest.raises(ValueError, match="unknown search engine"):
        evolutionary_search(net, chip, ev, engine="gpu")
    with pytest.raises(ValueError, match="population_size"):
        evolutionary_search(net, chip, ev, population_size=1)
    with pytest.raises(ValueError, match="generations"):
        evolutionary_search(net, chip, ev, generations=0)
    with pytest.raises(ValueError, match="genome shape"):
        evolutionary_search(net, chip, ev,
                            seed_candidates=[Candidate((1,), (0,))])
    # a snapshot of another engine is not resumed by this one
    R.SearchCheckpointer(str(tmp_path)).save(
        1, {"cores": np.zeros((1, 3), np.int32)}, {"engine": "device"})
    with pytest.raises(ValueError, match="'device' engine"):
        evolutionary_search(net, chip, ev, checkpoint_dir=str(tmp_path),
                            resume=True)
