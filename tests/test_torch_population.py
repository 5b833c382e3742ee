"""The port's population pricing and floorline guidance against the JAX
package's, on the CPU.

Same networks (same seeds), same candidates.  The port's ``"numpy"``
backend prices each candidate through ``price_candidate`` and is
bit-identical to the port's own ``simulate``; its ``"device"`` backend is
one batched float64 program and agrees with the reference's ``"numpy"``
backend to rtol 1e-9 (sums run in another order).  The NoC population
tables are exact small-integer counts and compare bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _repro_reference import reference
from repro_torch.core.analytical import Bottleneck
from repro_torch.core.guidance import (DEFAULT_STATE_WEIGHTS,
                                       floorline_layer_guidance,
                                       floorline_layer_weights)
from repro_torch.core.partitioner import SimEvaluator
from repro_torch.neuromorphic import (Partition, flow_matrix_population,
                                      flow_structures_rows, incidence_tables,
                                      loihi2_like, minimal_partition,
                                      network_from_numpy, ordered_mapping,
                                      random_mapping,
                                      router_incidence_population, simulate,
                                      simulate_population, strided_mapping)
from repro_torch.neuromorphic.noc import Mapping, _flow_matrix
from repro_torch.neuromorphic.partition import validate_partition
from repro_torch.neuromorphic.platform import speck_like
from repro_torch.neuromorphic.timestep import (POPULATION_BACKENDS,
                                               _pairs_to_rows,
                                               precompute_pricing,
                                               price_population_device)
from repro_torch.sparsity import SparsityProfile

RTOL = 1e-9
CPU = dict(device="cpu")
ARRAYS = ("times", "energies", "per_core_synops", "per_core_acts",
          "per_core_msgs_out")
SCALARS = ("time_per_step", "energy_per_step", "max_synops", "max_acts",
           "max_link_load")


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_reports_close(p, r, rtol=RTOL):
    """The reference's population parity check (every array, scalar,
    stage, core count and M0 metric), port report ``p`` against ``r``."""
    for f in ARRAYS:
        a, b = _np(getattr(p, f)), _np(getattr(r, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol, err_msg=f)
    for f in SCALARS:
        np.testing.assert_allclose(getattr(p, f), getattr(r, f), rtol=rtol,
                                   err_msg=f)
    assert p.bottleneck_stage == r.bottleneck_stage
    assert p.n_cores_active == r.n_cores_active
    mp, mr = p.metrics, r.metrics
    for f in ("msgs_total", "weight_density", "act_density"):
        np.testing.assert_allclose(getattr(mp, f), getattr(mr, f),
                                   rtol=rtol, err_msg=f)
    for s in ("synops", "acts", "traffic"):
        sp, sr = getattr(mp, s), getattr(mr, s)
        assert (sp.n_units, sp.n_active) == (sr.n_units, sr.n_active), s
        np.testing.assert_allclose([sp.total, sp.max, sp.imbalance],
                                   [sr.total, sr.max, sr.imbalance],
                                   rtol=rtol, err_msg=s)


def assert_reports_identical(a, b):
    for f in ARRAYS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in SCALARS + ("bottleneck_stage", "n_cores_active", "metrics"):
        assert getattr(a, f) == getattr(b, f), f


def _port_net(rn):
    """The reference network's layers, field for field, on the CPU."""
    return network_from_numpy(
        [{f.name: getattr(l, f.name) for f in dataclasses.fields(l)}
         for l in rn.layers], rn.in_size, **CPU)


def fc_workload(ref, sizes=(96, 128, 128, 64), wd=0.6, ad=0.3, steps=3):
    rn = ref.network.programmed_fc_network(
        list(sizes), weight_densities=[wd] * (len(sizes) - 1),
        act_densities=[ad] * (len(sizes) - 1), seed=0,
        weight_format="sparse")
    return rn, _port_net(rn), ref.network.make_inputs(sizes[0], ad, steps,
                                                      seed=1)


def conv_workload(ref, steps=3, profile_async=False):
    """The reference suite's conv stack (or its async Speck variant)."""
    rng = np.random.default_rng(7 if profile_async else 2)
    layers, h, c_prev = [], 8, 2
    for i, c in enumerate((4, 4) if profile_async else (4, 8)):
        wgt = rng.normal(0, 1 / 3.0, (3, 3, c_prev, c)).astype(np.float32)
        kw = dict(neuron_model="if", threshold=1.0) if profile_async else {}
        if not profile_async:
            wgt *= ref.network._exact_density_mask(wgt.shape, 0.6, rng)
        layers.append(ref.network.SimLayer(
            name=f"c{i}", kind="conv", weights=wgt, stride=2, in_hw=(h, h),
            **kw))
        h, c_prev = h // 2, c
    if not profile_async:
        wfc = rng.normal(0, 0.3, (h * h * c_prev, 10)).astype(np.float32)
        layers.append(ref.network.SimLayer(name="fc", kind="fc", weights=wfc))
    rn = ref.network.SimNetwork(layers=layers, in_size=8 * 8 * 2)
    return rn, _port_net(rn), ref.network.make_inputs(
        rn.in_size, 0.4, steps, seed=8 if profile_async else 3)


def _pairs(ref, parts_maps, prof_r):
    """Port (Partition, Mapping) pairs and their reference twins."""
    return [(ref.partition.Partition(p.cores), ref.noc.Mapping(m.phys))
            for p, m in parts_maps]


def _random_population(net, prof, rng, size):
    """Random legal partitions (splits of the minimal one) with ordered,
    strided and random mappings, drawn with numpy."""
    p0 = minimal_partition(net, prof)
    out = []
    for k in range(size):
        part = p0
        for _ in range(int(rng.integers(0, 6))):
            l = int(rng.integers(0, len(part.cores)))
            nxt = part.split(l)
            if nxt.total_cores <= prof.n_cores and \
                    validate_partition(net, nxt, prof):
                part = nxt
        kind = k % 3
        mapping = (ordered_mapping(part, prof) if kind == 0 else
                   strided_mapping(part, prof) if kind == 1 else
                   random_mapping(part, prof, rng))
        out.append((part, mapping))
    return out


def _check_population(ref, rn, pn, xs, prof_r, prof_p, pairs):
    r_np = ref.timestep.simulate_population(rn, xs, prof_r,
                                            _pairs(ref, pairs, prof_r))
    xt = torch.from_numpy(xs)
    cache = precompute_pricing(pn, xt, prof_p)
    p_np = simulate_population(pn, xt, prof_p, pairs, cache=cache)
    p_dev = simulate_population(pn, xt, prof_p, pairs, cache=cache,
                                backend="device")
    assert len(p_np) == len(p_dev) == len(r_np) == len(pairs)
    for (part, mapping), a, b, r in zip(pairs, p_np, p_dev, r_np):
        assert_reports_identical(a, simulate(pn, xt, prof_p, part, mapping))
        assert_reports_close(a, r)
        assert_reports_close(b, r)
        assert_reports_close(b, a)
    return p_np, p_dev


# ------------------------------------------------------ NoC population


def _genomes(rng, n_cores_phys, n=8):
    rows = []
    for _ in range(n):
        cores = rng.integers(1, 5, size=int(rng.integers(2, 6)))
        phys = rng.permutation(n_cores_phys)[:int(cores.sum())]
        rows.append((tuple(int(c) for c in cores),
                     tuple(int(p) for p in phys)))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_noc_population_tables_match_reference_exactly(ref, seed):
    prof = loihi2_like()
    rows = _genomes(np.random.default_rng(seed), prof.n_cores, n=10)
    cores, phys = [c for c, _ in rows], [p for _, p in rows]
    n_pad = max(sum(c) for c in cores) + 2
    ref.noc.flow_cache_clear()
    P_r, dup_r = ref.noc.flow_matrix_population(cores, phys, prof.grid,
                                                prof.n_cores, n_pad)
    P_p, dup_p = flow_matrix_population(cores, phys, prof.grid,
                                        prof.n_cores, n_pad, **CPU)
    assert P_p.dtype == dup_p.dtype == torch.float64
    assert np.array_equal(P_p.numpy(), P_r.astype(np.float64))
    assert np.array_equal(dup_p.numpy(), dup_r)
    for k, (c, ph) in enumerate(rows):
        P1, d1 = _flow_matrix(c, ph, prof.grid, prof.n_cores)
        assert np.array_equal(P_p[k, :P1.shape[0]].numpy(), P1)
        assert np.array_equal(dup_p[k, :P1.shape[0]].numpy(), d1)
    PL_r, ph_r, d_r = ref.noc.router_incidence_population(
        cores, phys, prof.grid, prof.n_cores, n_pad)
    PL_p, ph_p, d_p = router_incidence_population(
        cores, phys, prof.grid, prof.n_cores, n_pad, **CPU)
    for a, b in ((PL_p, PL_r), (ph_p, ph_r), (d_p, d_r)):
        assert np.array_equal(a.numpy(), b)
    inc3, hops2 = incidence_tables(prof.grid)
    assert np.array_equal(PL_p.numpy(), P_p.numpy() @ inc3.reshape(
        -1, inc3.shape[2]))
    assert np.array_equal(ph_p.numpy(), P_p.numpy() @ hops2.reshape(-1))


def test_flow_structures_rows_match_reference_exactly(ref):
    import jax.numpy as jnp
    prof = loihi2_like()
    rng = np.random.default_rng(4)
    L, ncap = 4, 40
    rows = []
    for _ in range(5):
        cores = rng.integers(1, 8, size=L)
        phys = rng.permutation(prof.n_cores)[:int(cores.sum())]
        rows.append((tuple(int(c) for c in cores),
                     tuple(int(p) for p in phys)))
    cpr = prof.n_cores // (prof.grid[0] * prof.grid[1])
    lid = np.zeros((5, ncap), np.int64)
    router = np.zeros((5, ncap), np.int64)
    alive = np.zeros((5, ncap))
    for k, (c, ph) in enumerate(rows):
        n = sum(c)
        lid[k, :n] = np.repeat(np.arange(L), c)
        router[k, :n] = np.asarray(ph) // cpr
        alive[k, :n] = 1.0
    inc3, hops2 = incidence_tables(prof.grid)
    PL, ph, dup = flow_structures_rows(
        torch.from_numpy(lid), torch.from_numpy(router),
        torch.from_numpy(alive), L, torch.from_numpy(inc3),
        torch.from_numpy(hops2))
    PL_b, ph_b, dup_b = router_incidence_population(
        [c for c, _ in rows], [p for _, p in rows], prof.grid,
        prof.n_cores, ncap, **CPU)
    assert torch.equal(PL, PL_b) and torch.equal(ph, ph_b) \
        and torch.equal(dup, dup_b)
    inc3_r, hops2_r = ref.noc.incidence_tables(prof.grid)
    with ref.timestep.enable_x64():
        for k in range(5):
            out_r = ref.noc.flow_structures_rows(
                jnp.asarray(lid[k]), jnp.asarray(router[k]),
                jnp.asarray(alive[k]), L, jnp.asarray(inc3_r),
                jnp.asarray(hops2_r))
            one = flow_structures_rows(
                torch.from_numpy(lid[k]), torch.from_numpy(router[k]),
                torch.from_numpy(alive[k]), L, torch.from_numpy(inc3),
                torch.from_numpy(hops2))
            for a, b in zip(one, out_r):
                assert np.array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------- simulate_population


def test_fc_population_matches_reference(ref):
    rn, pn, xs = fc_workload(ref)
    prof = loihi2_like()
    p0 = minimal_partition(pn, prof)
    rng = np.random.default_rng(4)
    pairs = [(p0, ordered_mapping(p0, prof)),
             (p0.split(0), strided_mapping(p0.split(0), prof)),
             (p0.split(1).split(1),
              random_mapping(p0.split(1).split(1), prof, rng))]
    _check_population(ref, rn, pn, xs, ref.platform.loihi2_like(), prof,
                      pairs)


def test_conv_population_matches_reference(ref):
    rn, pn, xs = conv_workload(ref)
    prof = loihi2_like()
    pairs = [(p, strided_mapping(p, prof)) for p in
             (Partition((1, 1, 1)), Partition((2, 4, 2)),
              Partition((4, 8, 1)))]
    _check_population(ref, rn, pn, xs, ref.platform.loihi2_like(), prof,
                      pairs)


def test_empty_core_segments_population_matches_reference(ref):
    """More cores than neurons: empty segments sum to exactly 0."""
    rn = ref.network.fc_network([16, 6, 8], weight_density=1.0, seed=19)
    xs = ref.network.make_inputs(16, 0.8, 3, seed=20)
    prof = loihi2_like()
    pairs = [(Partition((1, 1)), ordered_mapping(Partition((1, 1)), prof)),
             (Partition((7, 2)), strided_mapping(Partition((7, 2)), prof))]
    _check_population(ref, rn, _port_net(rn), xs,
                      ref.platform.loihi2_like(), prof, pairs)


def test_async_platform_population_matches_reference(ref):
    """Speck-like chips take the pipeline-latency branch (per-layer
    segment maxima instead of the barrier max)."""
    rn, pn, xs = conv_workload(ref, profile_async=True)
    prof = speck_like()
    p = minimal_partition(pn, prof)
    pairs = [(p, ordered_mapping(p, prof)),
             (p, random_mapping(p, prof, np.random.default_rng(3)))]
    p_np, p_dev = _check_population(ref, rn, pn, xs,
                                    ref.platform.speck_like(), prof, pairs)
    assert {r.bottleneck_stage for r in p_dev} == {"memory"}


def test_large_population_spot_checks(ref, monkeypatch):
    """A 32-candidate population of random splits and mappings, priced in
    row blocks of 7 candidates on the device path."""
    import repro_torch.neuromorphic.timestep as ts
    rn, pn, xs = fc_workload(ref, steps=2)
    prof = loihi2_like()
    pairs = _random_population(pn, prof, np.random.default_rng(9), 32)
    assert len({p.cores for p, _ in pairs}) > 4
    monkeypatch.setattr(ts, "_BLOCK_ELEMS",
                        2 * 7 * ts.population_pad_width(pn, prof))
    _check_population(ref, rn, pn, xs, ref.platform.loihi2_like(), prof,
                      pairs)


def test_device_rows_match_reference_genome_encoding(ref):
    rn, pn, xs = fc_workload(ref, steps=2)
    prof = loihi2_like()
    pairs = _random_population(pn, prof, np.random.default_rng(5), 6)
    cores, perm = _pairs_to_rows(pairs, len(pn.layers), prof.n_cores)
    cores_r, perm_r = ref.timestep._pairs_to_rows(
        _pairs(ref, pairs, None), len(rn.layers), prof.n_cores)
    assert np.array_equal(cores, cores_r) and np.array_equal(perm, perm_r)
    xt = torch.from_numpy(xs)
    cache = precompute_pricing(pn, xt, prof)
    a = price_population_device(pn, prof, cache, cores, perm)
    b = price_population_device(pn, prof, cache, torch.from_numpy(cores),
                                torch.from_numpy(perm))
    for x, y in zip(a, b):
        assert_reports_identical(x, y)
    with pytest.raises(ValueError, match="genome rows"):
        price_population_device(pn, prof, cache, cores[:, :2], perm)


def test_population_backends_and_validation(ref):
    rn, pn, xs = fc_workload(ref, steps=2)
    prof = loihi2_like()
    xt = torch.from_numpy(xs)
    p0 = minimal_partition(pn, prof)
    pair = [(p0, ordered_mapping(p0, prof))]
    assert POPULATION_BACKENDS == ("numpy", "device")
    for backend in ("vmap", "sharded"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            simulate_population(pn, xt, prof, pair, backend=backend)
    with pytest.raises(ValueError, match="backend"):
        simulate_population(pn, xt, prof, pair, backend="tpu")
    # a trained profile is programmed onto the network before the run, so
    # it cannot be combined with a cache bound to the un-profiled one
    trained = SparsityProfile(("fc0",), [0.5], [0.8])
    with pytest.raises(ValueError, match="un-profiled"):
        simulate_population(pn, xt, prof, pair, sparsity_profile=trained,
                            cache=precompute_pricing(pn, xt, prof))
    profiled = simulate_population(pn, xt, prof, pair,
                                   sparsity_profile=trained)
    assert profiled[0].metrics.weight_density < simulate_population(
        pn, xt, prof, pair)[0].metrics.weight_density
    bad = [(p0.split(0), ordered_mapping(p0, prof))]
    with pytest.raises(ValueError, match="agree"):
        simulate_population(pn, xt, prof, bad)
    assert simulate_population(pn, xt, prof, []) == []


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_evaluate_population_matches_reference(ref, backend):
    rn, pn, xs = fc_workload(ref)
    prof = loihi2_like()
    ev_r = ref.partitioner.SimEvaluator(rn, xs, ref.platform.loihi2_like(),
                                        fallback=False)
    ev_p = SimEvaluator(pn, torch.from_numpy(xs), prof,
                        population_backend=backend, fallback=False)
    p0 = minimal_partition(pn, prof)
    pairs = [(p0, strided_mapping(p0, prof)),
             (p0.split(1), ordered_mapping(p0.split(1), prof)),
             (p0.split(2), strided_mapping(p0.split(2), prof))]
    r = ev_r.evaluate_population(_pairs(ref, pairs, None))
    p = ev_p.evaluate_population(pairs)
    assert ev_p.n_evals == ev_r.n_evals == 3
    assert ev_p.demotions == [] and ev_p.active_backend == backend
    for a, b in zip(p, r):
        assert_reports_close(a, b)
    ev_p(*pairs[0])
    ev_r(*_pairs(ref, pairs[:1], None)[0])
    assert ev_p.n_evals == ev_r.n_evals == 4
    # fail fast: a backend the port lacks raises, and no fallback prices
    ev_bad = SimEvaluator(pn, torch.from_numpy(xs), prof, cache=ev_p.cache,
                          population_backend="vmap")
    with pytest.raises(NotImplementedError):
        ev_bad.evaluate_population(pairs)


def test_evaluate_population_reference_engine_counts(ref):
    rn, pn, xs = fc_workload(ref, sizes=(48, 64, 32), steps=2)
    prof = loihi2_like()
    ev_r = ref.partitioner.SimEvaluator(rn, xs, ref.platform.loihi2_like(),
                                        engine="reference", fallback=False)
    ev_p = SimEvaluator(pn, torch.from_numpy(xs), prof, engine="reference")
    p0 = minimal_partition(pn, prof)
    pairs = [(p0, strided_mapping(p0, prof)),
             (p0.split(0), ordered_mapping(p0.split(0), prof))]
    r = ev_r.evaluate_population(_pairs(ref, pairs, None))
    p = ev_p.evaluate_population(pairs)
    assert ev_p.cache is None and ev_p.n_evals == ev_r.n_evals == 2
    for a, b in zip(p, r):
        assert_reports_close(a, b)


# ------------------------------------------------------------ guidance


@pytest.mark.parametrize("case", ["fc", "fc_strided", "conv", "async"])
def test_floorline_guidance_matches_reference(ref, case):
    if case == "conv":
        rn, pn, xs = conv_workload(ref)
    elif case == "async":
        rn, pn, xs = conv_workload(ref, profile_async=True)
    else:
        rn, pn, xs = fc_workload(ref, sizes=(96, 160, 128, 64), steps=4)
    prof_p = speck_like() if case == "async" else loihi2_like()
    prof_r = (ref.platform.speck_like() if case == "async"
              else ref.platform.loihi2_like())
    part = mapping = None
    if case == "fc_strided":
        part = minimal_partition(pn, prof_p).split(1)
        mapping = strided_mapping(part, prof_p)
    args_r = (_pairs(ref, [(part, mapping)], None)[0] if part is not None
              else (None, None))
    g_r = ref.guidance.floorline_layer_guidance(rn, xs, prof_r, *args_r)
    g_p = floorline_layer_guidance(pn, torch.from_numpy(xs), prof_p, part,
                                   mapping)
    assert [g.name for g in g_p] == [g.name for g in g_r]
    assert [g.state.value for g in g_p] == [g.state.value for g in g_r]
    np.testing.assert_allclose([g.weight for g in g_p],
                               [g.weight for g in g_r], rtol=RTOL)
    for a, b in zip(g_p, g_r):
        np.testing.assert_allclose(
            [a.stage.mem_time, a.stage.act_time, a.stage.traffic_time],
            [b.stage.mem_time, b.stage.act_time, b.stage.traffic_time],
            rtol=RTOL)
    w_p = floorline_layer_weights(pn, torch.from_numpy(xs), prof_p, part,
                                  mapping)
    w_r = ref.guidance.floorline_layer_weights(rn, xs, prof_r, *args_r)
    np.testing.assert_allclose(w_p, w_r, rtol=RTOL)
    assert w_p.dtype == np.float64
    np.testing.assert_allclose(w_p.mean(), 1.0, rtol=1e-12)


def test_guidance_state_weights_and_tolerance(ref):
    rn, pn, xs = fc_workload(ref, steps=3)
    prof = loihi2_like()
    xt = torch.from_numpy(xs)
    cache = precompute_pricing(pn, xt, prof)
    custom = {Bottleneck.TRAFFIC: 5.0, Bottleneck.MEMORY: 1.0,
              Bottleneck.COMPUTE: 0.5}
    for tol in (0.0, 0.25, 10.0):
        g_p = floorline_layer_guidance(pn, xt, prof, cache=cache,
                                       state_weights=custom, traffic_tol=tol)
        g_r = ref.guidance.floorline_layer_guidance(
            rn, xs, ref.platform.loihi2_like(), traffic_tol=tol,
            state_weights={getattr(ref.guidance.Bottleneck, b.name): v
                           for b, v in custom.items()})
        assert [g.state.value for g in g_p] == [g.state.value for g in g_r]
        np.testing.assert_allclose([g.weight for g in g_p],
                                   [g.weight for g in g_r], rtol=RTOL)
    assert set(DEFAULT_STATE_WEIGHTS) == set(Bottleneck)
