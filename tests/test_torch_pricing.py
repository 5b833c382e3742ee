"""The port's pricing, floorline and partitioner against the JAX package's.

Same networks (same seeds), same inputs, run on the CPU.  Priced reports
are float64 sums of exact integer counters, so times, energies and per-core
arrays agree to rtol 1e-9; the floorline class and the greedy §VI-B walk
(every move, partition and accept / backtrack decision) are identical.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from _repro_reference import reference
from repro_torch.core.floorline import WorkloadPoint, fit_floorline
from repro_torch.core.partitioner import SimEvaluator, optimize_partitioning
from repro_torch.neuromorphic import (EventCompute, Partition, fc_network,
                                      loihi2_like, make_inputs,
                                      minimal_partition, network_from_numpy,
                                      ordered_mapping, route_batch,
                                      route_step, simulate, strided_mapping)
from repro_torch.neuromorphic.platform import speck_like
from repro_torch.neuromorphic.timestep import layer_stage_times

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRICE_RTOL = 1e-9
REPORT_ARRAYS = ("times", "energies", "per_core_synops", "per_core_acts",
                 "per_core_msgs_out")
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _export(net) -> list[dict]:
    return [{f.name: getattr(l, f.name) for f in dataclasses.fields(l)}
            for l in net.layers]


def assert_reports_match(r, p):
    for f in REPORT_ARRAYS:
        np.testing.assert_allclose(getattr(p, f).numpy(), getattr(r, f),
                                   rtol=PRICE_RTOL, err_msg=f)
    for f in ("time_per_step", "energy_per_step", "max_synops", "max_acts",
              "max_link_load"):
        np.testing.assert_allclose(getattr(p, f), getattr(r, f),
                                   rtol=PRICE_RTOL, err_msg=f)
    assert p.bottleneck_stage == r.bottleneck_stage
    assert p.n_cores_active == r.n_cores_active
    for f in ("msgs_total", "weight_density", "act_density"):
        np.testing.assert_allclose(getattr(p.metrics, f),
                                   getattr(r.metrics, f), rtol=PRICE_RTOL)
    np.testing.assert_allclose(p.outputs.numpy(), np.asarray(r.outputs),
                               rtol=1e-6, atol=1e-6)


def _pair(ref, sizes, model="relu", thr=0.0, seed=0, wd=0.5):
    rn = ref.network.fc_network(sizes, weight_density=wd, neuron_model=model,
                                seed=seed)
    pn = network_from_numpy(_export(rn), rn.in_size, **CPU)
    for a, b in zip(rn.layers, pn.layers):
        a.threshold = b.threshold = thr
    return rn, pn


@pytest.mark.parametrize("engine", ["batched", "reference"])
@pytest.mark.parametrize("model,thr", [("relu", 0.0), ("if", 0.6),
                                       ("sd_relu", 0.03), ("ssm", 0.0)])
def test_simulate_matches_reference(ref, engine, model, thr):
    rn, pn = _pair(ref, [96, 128, 64], model, thr)
    xs = ref.network.make_inputs(96, 0.4, 5, seed=1)
    r = ref.timestep.simulate(rn, xs, ref.platform.loihi2_like(),
                              engine=engine)
    p = simulate(pn, torch.from_numpy(xs), loihi2_like(), engine=engine)
    assert_reports_match(r, p)


@pytest.mark.parametrize("compute", ["dense", "event"])
def test_partitioned_mappings_and_async_match_reference(ref, compute):
    rn, pn = _pair(ref, [128, 192, 192, 64], wd=0.4, seed=15)
    xs = ref.network.make_inputs(128, 0.6, 5, seed=16)
    prof_r, prof_p = ref.platform.loihi2_like(), loihi2_like()
    part_r, part_p = ref.partition.Partition((6, 8, 3)), Partition((6, 8, 3))
    for mk_r, mk_p in ((ref.noc.ordered_mapping, ordered_mapping),
                       (ref.noc.strided_mapping, strided_mapping)):
        r = ref.timestep.simulate(rn, xs, prof_r, part_r, mk_r(part_r, prof_r),
                                  compute=compute)
        p = simulate(pn, torch.from_numpy(xs), prof_p, part_p,
                     mk_p(part_p, prof_p), compute=compute)
        assert_reports_match(r, p)
    rn, pn = _pair(ref, [96, 64, 10], "if", 0.5, seed=11, wd=1.0)
    xs = ref.network.make_inputs(96, 0.3, 6, seed=12)
    r = ref.timestep.simulate(rn, xs, ref.platform.speck_like(),
                              compute=compute)
    p = simulate(pn, torch.from_numpy(xs), speck_like(), compute=compute)
    assert_reports_match(r, p)
    assert p.bottleneck_stage == "memory"


def test_empty_core_segments_match_reference(ref):
    """More cores than neurons: empty segments sum to exactly 0."""
    rn, pn = _pair(ref, [16, 6, 8], wd=1.0, seed=19)
    xs = ref.network.make_inputs(16, 0.8, 3, seed=20)
    r = ref.timestep.simulate(rn, xs, ref.platform.loihi2_like(),
                              ref.partition.Partition((7, 1)))
    p = simulate(pn, torch.from_numpy(xs), loihi2_like(), Partition((7, 1)))
    assert_reports_match(r, p)


def test_engines_bit_exact_within_port():
    net = fc_network([64, 96, 96, 32], neuron_model="sd_relu", seed=5, **CPU)
    for l in net.layers:
        l.threshold, l.sends_deltas = 0.02, True
    xs = make_inputs(64, 0.5, 8, seed=6, **CPU)
    for prof in (loihi2_like(), speck_like()):
        a = simulate(net, xs, prof, engine="batched")
        b = simulate(net, xs, prof, engine="reference")
        for f in REPORT_ARRAYS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert (a.max_synops, a.max_acts, a.max_link_load,
                a.bottleneck_stage) == (b.max_synops, b.max_acts,
                                        b.max_link_load, b.bottleneck_stage)
        assert a.metrics == b.metrics


def test_route_batch_matches_route_step_and_reference(ref):
    prof = loihi2_like()
    part = Partition((5, 7, 3))
    rng = np.random.default_rng(0)
    T, n = 6, part.total_cores
    msgs = rng.integers(0, 40, (T, n)).astype(np.float64)
    offsets = np.concatenate([[0], np.cumsum(part.cores)]).astype(int)
    for mapping in (ordered_mapping(part, prof), strided_mapping(part, prof)):
        batch = route_batch(part, mapping, torch.from_numpy(msgs), prof)
        rb = ref.noc.route_batch(ref.partition.Partition(part.cores),
                                 ref.noc.Mapping(mapping.phys), msgs,
                                 ref.platform.loihi2_like())
        assert np.array_equal(batch.router_loads.numpy(), rb.router_loads)
        assert np.array_equal(batch.total_hops.numpy(), rb.total_hops)
        for t in range(T):
            per_layer = [torch.from_numpy(msgs[t, offsets[l]:offsets[l + 1]])
                         for l in range(len(part.cores))]
            step = route_step(part, mapping, per_layer, prof)
            assert torch.equal(batch.router_loads[t], step.router_loads)
            assert float(batch.total_hops[t]) == float(step.total_hops)
            assert torch.equal(batch.inject_per_core[t],
                               step.inject_per_core)


def test_layer_stage_times_and_evaluator_match_reference(ref):
    rn, pn = _pair(ref, [48, 96, 64, 32], wd=0.5, seed=1)
    xs = ref.network.make_inputs(48, 0.25, 12, seed=2)
    for a, b in zip(ref.timestep.layer_stage_times(
            rn, xs, ref.platform.loihi2_like()),
            layer_stage_times(pn, torch.from_numpy(xs), loihi2_like())):
        assert a.name == b.name
        np.testing.assert_allclose(
            [b.mem_time, b.act_time, b.traffic_time, b.msgs_out],
            [a.mem_time, a.act_time, a.traffic_time, a.msgs_out],
            rtol=PRICE_RTOL)
    ev_r = ref.partitioner.SimEvaluator(rn, xs, ref.platform.loihi2_like(),
                                        compute="event")
    ev_p = SimEvaluator(pn, torch.from_numpy(xs), loihi2_like(),
                        compute="event")
    part = Partition((2, 3, 1))
    assert_reports_match(
        ev_r(ref.partition.Partition(part.cores),
             ref.noc.Mapping(strided_mapping(part, loihi2_like()).phys)),
        ev_p(part, strided_mapping(part, loihi2_like())))
    assert ev_p.n_evals == 1


def _quickstart(M, F, P, net, xs, prof, inputs, conv):
    """``examples/quickstart.py``'s three steps through either package."""
    part = M.partition.minimal_partition(net, prof)
    base = M.timestep.simulate(net, xs, prof, part,
                               M.noc.ordered_mapping(part, prof))
    pts = []
    for dens in (0.8, 0.5, 0.3, 0.1, 0.05):
        r = M.timestep.simulate(net, conv(inputs(128, dens, 5, seed=2)),
                                prof)
        pts.append(F.WorkloadPoint(r.max_synops, r.max_acts,
                                   r.time_per_step, r.energy_per_step))
    model = F.fit_floorline(pts)
    point = F.WorkloadPoint(base.max_synops, base.max_acts,
                            base.time_per_step)
    res = P.optimize_partitioning(
        net, prof, lambda pa, ma: M.timestep.simulate(net, xs, prof, pa, ma))
    return model, model.classify(point), res


def test_quickstart_floorline_and_greedy_match_reference(ref):
    import types
    import repro_torch.core.floorline as pf
    import repro_torch.core.partitioner as pp
    import repro_torch.neuromorphic.noc as pnoc
    import repro_torch.neuromorphic.partition as ppart
    import repro_torch.neuromorphic.timestep as pts
    rn, pn = _pair(ref, [128, 256, 256, 64], wd=0.5, seed=0)
    xs = ref.network.make_inputs(128, 0.3, 5, seed=1)
    m_r, s_r, res_r = _quickstart(ref, ref.floorline, ref.partitioner, rn,
                                  xs, ref.platform.loihi2_like(),
                                  ref.network.make_inputs, lambda a: a)
    port = types.SimpleNamespace(partition=ppart, timestep=pts, noc=pnoc)
    m_p, s_p, res_p = _quickstart(
        port, pf, pp, pn, torch.from_numpy(xs), loihi2_like(),
        lambda *a, **k: make_inputs(*a, **k, **CPU), lambda a: a)
    assert s_p.value == s_r.value
    np.testing.assert_allclose(
        [m_p.mem_latency, m_p.act_latency, m_p.t0],
        [m_r.mem_latency, m_r.act_latency, m_r.t0], rtol=PRICE_RTOL)
    assert len(res_p.history) == len(res_r.history)
    for a, b in zip(res_r.history, res_p.history):
        assert (a.iteration, a.assumption.value, a.move, a.partition.cores,
                a.accepted, a.note) == (b.iteration, b.assumption.value,
                                        b.move, b.partition.cores,
                                        b.accepted, b.note)
        np.testing.assert_allclose([b.time, b.energy, b.max_synops],
                                   [a.time, a.energy, a.max_synops],
                                   rtol=PRICE_RTOL)
    assert res_p.partition.cores == res_r.partition.cores
    assert res_p.mapping.phys == res_r.mapping.phys


def test_floorline_fit_matches_reference(ref):
    rng = np.random.default_rng(0)
    raw = [(float(s), float(a), float(t)) for s, a, t in
           zip(rng.uniform(10, 1000, 12), rng.uniform(5, 50, 12),
               rng.uniform(100, 3000, 12))]
    m_r = ref.floorline.fit_floorline(
        [ref.floorline.WorkloadPoint(*p) for p in raw])
    m_p = fit_floorline([WorkloadPoint(*p) for p in raw])
    assert (m_p.mem_latency, m_p.act_latency, m_p.t0) == \
        (m_r.mem_latency, m_r.act_latency, m_r.t0)
    for p in raw:
        assert m_p.classify(WorkloadPoint(*p)).value == \
            m_r.classify(ref.floorline.WorkloadPoint(*p)).value


def test_greedy_on_evaluator_is_deterministic():
    net = fc_network([64, 128, 64], weight_density=0.5, seed=2, **CPU)
    xs = make_inputs(64, 0.3, 6, seed=3, **CPU)
    prof = loihi2_like()
    runs = [optimize_partitioning(net, prof, SimEvaluator(
        net, xs, prof, compute=EventCompute(mode="kernel")), max_iters=6)
        for _ in range(2)]
    assert [h.move for h in runs[0].history] == \
        [h.move for h in runs[1].history]
    assert runs[0].partition == runs[1].partition
    assert minimal_partition(net, prof).total_cores <= \
        runs[0].partition.total_cores


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in files
             if p.is_relative_to(ROOT / "src" / "repro_torch")}
    assert {"sparsity/pruning.py", "sparsity/regularizers.py",
            "train/data.py", "train/sparse.py", "core/prng.py"} <= names
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
