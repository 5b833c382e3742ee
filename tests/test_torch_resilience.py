"""The port's fault-tolerance layer and checkpoint layout against the JAX
package's, on the CPU.

Fault plans, the byte-set and RNG codecs and the checkpoint files are
host numpy and JSON in both packages and compare exactly.  The port's
fallback chain has two links, ``device -> numpy`` (it has no ``vmap``
backend), and records demotions with the reference's fields.  Quarantine
and the finite mean are bit-equal to the reference's with numpy and to
torch's own ``mean()`` with torch.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _repro_reference import reference
from _torch_workloads import fc_pair
from repro_torch.core import resilience as R
from repro_torch.core.partitioner import SimEvaluator
from repro_torch.neuromorphic import (loihi2_like, minimal_partition,
                                      ordered_mapping, random_mapping,
                                      strided_mapping)
from repro_torch.train import checkpoint as ckpt

RTOL = 1e-9


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


# ---------------------------------------------------------- fault plans

def test_fault_plan_schedules_match_reference(ref):
    def drive(mod):
        plan = mod.FaultPlan(fail={"device": 2, "numpy": mod.ALWAYS},
                             nan_rows={1: (0, 2, 9), 3: (1,)},
                             kill_after_gen=3)
        log = []
        for site in ("device", "device", "device", "numpy", "vmap"):
            try:
                plan.check(site)
                log.append((site, "ok"))
            except mod.InjectedFault as e:
                log.append((site, str(e)))
        for _ in range(4):
            t, e = plan.corrupt_arrays(np.arange(4.0), np.arange(4.0) + 1)
            log.append((t.tolist(), e.tolist()))
        for gen in range(6):
            try:
                plan.after_generation(gen)
                log.append(("gen", gen))
            except mod.SimulatedCrash as e:
                log.append(("killed", str(e)))
        return log, plan.calls, plan.fail["numpy"]
    got, want = drive(R), drive(ref.resilience)
    assert repr(got) == repr(want)          # NaN-safe equality
    assert ("killed", "injected kill after generation 3") in got[0]
    assert issubclass(R.SimulatedCrash, BaseException)
    assert not issubclass(R.SimulatedCrash, Exception)


def test_fault_plan_corrupts_reports_in_place():
    class Rep:
        time_per_step = 1.0
        energy_per_step = 2.0
    plan = R.FaultPlan(nan_rows={0: (1, 5)})
    reps = [Rep(), Rep(), Rep()]
    assert plan.corrupt(reps) is reps and plan.calls == 1
    assert np.isnan(reps[1].time_per_step)
    assert np.isnan(reps[1].energy_per_step)
    assert reps[0].time_per_step == 1.0 and reps[2].energy_per_step == 2.0
    plan.corrupt(reps)                       # call 1: nothing scheduled
    assert reps[0].time_per_step == 1.0 and plan.calls == 2


# ------------------------------------------------------- fallback chain

def test_demotion_record_fields_match_reference(ref):
    assert [f.name for f in dataclasses.fields(R.Demotion)] \
        == [f.name for f in dataclasses.fields(ref.resilience.Demotion)]
    assert [f.name for f in dataclasses.fields(R.RetryPolicy)] \
        == [f.name for f in dataclasses.fields(ref.resilience.RetryPolicy)]
    assert R.FallbackChain.CHAIN == ("device", "numpy")
    assert ref.resilience.FallbackChain.CHAIN == ("device", "vmap", "numpy")


@pytest.mark.parametrize("failures,retries,demoted", [
    (0, 1, False), (1, 1, False), (2, 1, True), (3, 2, True), (2, 0, True)])
def test_fallback_chain_retries_then_demotes(ref, failures, retries,
                                             demoted):
    """The port's device link behaves as the reference's vmap link: the
    last link before numpy."""
    def run(mod, start):
        calls = []

        def attempt(backend):
            calls.append(backend)
            if backend == start and calls.count(start) <= failures:
                raise mod.InjectedFault(f"boom {len(calls)}")
            return backend
        chain = mod.FallbackChain(start, retry=mod.RetryPolicy(
            max_retries=retries))
        return chain.run(attempt), calls, chain.demotions, chain.backend
    got, calls, dem, backend = run(R, "device")
    want, calls_r, dem_r, backend_r = run(ref.resilience, "vmap")
    assert got == ("numpy" if demoted else "device")
    assert want == ("numpy" if demoted else "vmap")
    assert [c.replace("device", "vmap") for c in calls] == calls_r
    assert len(dem) == len(dem_r) == int(demoted)
    for d, e in zip(dem, dem_r):
        assert (d.site, d.frm, d.to, d.error, d.retries) \
            == (e.site, "device", "numpy", e.error, e.retries)
    assert backend == ("numpy" if demoted else "device")


def test_fallback_chain_last_link_and_crash_propagate(monkeypatch):
    sleeps = []
    monkeypatch.setattr(R.time, "sleep", sleeps.append)
    chain = R.FallbackChain("device", retry=R.RetryPolicy(
        max_retries=2, backoff_s=0.5, multiplier=3.0))

    def fail(backend):
        raise ValueError(backend)
    with pytest.raises(ValueError, match="numpy"):
        chain.run(fail)
    assert sleeps == [0.5, 1.5, 0.5, 1.5]
    assert [(d.frm, d.to) for d in chain.demotions] == [("device", "numpy")]

    def crash(backend):
        raise R.SimulatedCrash("kill")
    with pytest.raises(R.SimulatedCrash):
        R.FallbackChain("device").run(crash)


def test_evaluator_demotes_device_to_numpy(ref):
    _, net, xs = fc_pair(ref)
    chip = loihi2_like()
    p0 = minimal_partition(net, chip)
    cands = [(p0, ordered_mapping(p0, chip)), (p0, strided_mapping(p0, chip)),
             (p0.split(0), random_mapping(p0.split(0), chip,
                                          np.random.default_rng(1)))]
    numpy_ev = SimEvaluator(net, xs, chip)
    want = numpy_ev.evaluate_population(cands)
    ev = SimEvaluator(net, xs, chip, cache=numpy_ev.cache,
                      population_backend="device",
                      fault_plan=R.FaultPlan(fail={"device": 2},
                                             nan_rows={1: (2,)}))
    assert ev.active_backend == "device" and ev.demotions == []
    got = ev.evaluate_population(cands)
    assert ev.active_backend == "numpy"
    assert [(d.site, d.frm, d.to, d.retries) for d in ev.demotions] \
        == [("population pricing", "device", "numpy", 1)]
    assert "InjectedFault" in ev.demotions[0].error
    for a, b in zip(got, want):               # numpy's own bits
        assert a.time_per_step == b.time_per_step
    again = ev.evaluate_population(cands)      # sticky, call 1 corrupted
    assert len(ev.demotions) == 1 and ev.n_evals == 6
    assert np.isnan(again[2].time_per_step)
    assert again[0].time_per_step == want[0].time_per_step

    fast = SimEvaluator(net, xs, chip, cache=numpy_ev.cache,
                        population_backend="device", fallback=False,
                        fault_plan=R.FaultPlan(fail={"device": 1}))
    with pytest.raises(R.InjectedFault):
        fast.evaluate_population(cands)
    assert fast.demotions == [] and fast.active_backend == "device"


# --------------------------------------------------------- quarantine

CASES = {
    "finite": ([3.0, 1.5, 2.25, 7.0], [1.0, 2.0, 3.0, 4.0]),
    "nan and inf": ([3.0, np.nan, 2.0, np.inf], [1.0, 2.0, np.nan, 4.0]),
    "none finite": ([np.nan, np.inf], [1.0, 2.0]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_quarantine_and_finite_mean_match_reference(ref, case):
    t, e = (np.asarray(a, np.float64) for a in CASES[case])
    want = ref.resilience.quarantine_rows(np, t, e)
    got = R.quarantine_rows(np, t, e)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got_t = R.quarantine_rows(torch, torch.from_numpy(t),
                              torch.from_numpy(e))
    for a, b in zip(got_t, want):
        assert np.array_equal(a.numpy(), b)
    assert got_t[0].dtype == torch.float64 and got_t[2].dtype == torch.bool
    m_ref = ref.resilience.finite_mean(np, t)
    assert float(R.finite_mean(np, t)) == float(m_ref)
    m_t = R.finite_mean(torch, torch.from_numpy(t))
    assert m_t.dtype == torch.float64
    np.testing.assert_allclose(float(m_t), float(m_ref), rtol=1e-15)
    if case == "finite":
        assert float(R.finite_mean(np, t)) == float(t.mean())
        tt = torch.from_numpy(t)
        assert float(R.finite_mean(torch, tt)) == float(tt.mean())
    if case == "none finite":
        assert float(R.finite_mean(torch, torch.from_numpy(t))) == np.inf


def test_finite_mean_bit_equal_to_mean_at_population_size():
    rng = np.random.default_rng(0)
    v = rng.lognormal(7.0, 0.3, 64)
    assert float(R.finite_mean(np, v)) == float(v.mean())
    tv = torch.from_numpy(v)
    assert float(R.finite_mean(torch, tv)) == float(tv.mean())


# -------------------------------------------------------------- codecs

def test_byte_set_and_rng_codecs_match_reference(ref):
    keys = {b"\x01\x00\x00\x00abc", b"", b"zz", b"\x00" * 9}
    buf, lens = R.encode_bytes_set(keys)
    rbuf, rlens = ref.resilience.encode_bytes_set(keys)
    assert np.array_equal(buf, rbuf) and np.array_equal(lens, rlens)
    assert buf.dtype == np.uint8 and lens.dtype == np.int64
    assert R.decode_bytes_set(buf, lens) == keys
    assert ref.resilience.decode_bytes_set(buf, lens) == keys
    empty = R.encode_bytes_set(set())
    assert empty[0].shape == (0,) and R.decode_bytes_set(*empty) == set()

    rng = np.random.default_rng(42)
    rng.integers(0, 10, 7)
    state = json.loads(json.dumps(R.rng_state(rng)))     # via JSON
    assert state == ref.resilience.rng_state(rng)
    a = R.rng_from_state(state)
    b = ref.resilience.rng_from_state(state)
    nxt = rng.integers(0, 1 << 30, 16)
    assert np.array_equal(a.integers(0, 1 << 30, 16), nxt)
    assert np.array_equal(b.integers(0, 1 << 30, 16), nxt)
    assert np.array_equal(b.random(5), a.random(5))
    with pytest.raises(ValueError, match="checkpoint RNG"):
        R.rng_from_state(dict(state, bit_generator="MT19937"))


def test_validate_resume_meta(ref):
    for mod in (R, ref.resilience):
        mod.validate_resume_meta({"engine": "numpy", "k": 2},
                                 engine="numpy", checkpoint_dir="d",
                                 expect={"k": 2})
        with pytest.raises(ValueError, match="'device' engine"):
            mod.validate_resume_meta({"engine": "device"}, engine="numpy",
                                     checkpoint_dir="d")
        with pytest.raises(ValueError, match="k=3"):
            mod.validate_resume_meta({"engine": "numpy", "k": 3},
                                     engine="numpy", checkpoint_dir="d",
                                     expect={"k": 2})


# ------------------------------------------------------ checkpoint layout

def _state():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "opt": {"mu": rng.normal(size=5), "step": np.int64(7)},
            "b": np.arange(6, dtype=np.int32)}


def test_checkpoint_layout_matches_reference(ref, tmp_path):
    st = _state()
    ckpt.save(str(tmp_path / "p"), 12, st, extra={"it": 3})
    ref.checkpoint.save(str(tmp_path / "r"), 12, st, extra={"it": 3})
    for d in ("p", "r"):
        assert sorted(os.listdir(tmp_path / d)) == ["meta.json",
                                                    "step_00000012.npz"]
        with open(tmp_path / d / "meta.json") as f:
            assert json.load(f) == {"latest_step": 12, "extra": {"it": 3}}
    with np.load(tmp_path / "p" / "step_00000012.npz") as p, \
            np.load(tmp_path / "r" / "step_00000012.npz") as r:
        assert sorted(p.files) == sorted(r.files) == [
            "['b']", "['opt']|['mu']", "['opt']|['step']", "['w']"]
        for k in p.files:
            assert p[k].dtype == r[k].dtype and np.array_equal(p[k], r[k])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_across_packages(ref, tmp_path, writer):
    st = _state()
    (ckpt if writer == "port" else ref.checkpoint).save(
        str(tmp_path), 5, st, extra={"cursor": 9})
    like = {"w": torch.zeros((3, 4)), "opt": {"mu": np.zeros(5),
                                              "step": np.int64(0)},
            "b": np.zeros(6, np.int32)}
    got, step, extra = ckpt.restore(str(tmp_path), like)
    assert (step, extra) == (5, {"cursor": 9})
    assert isinstance(got["w"], torch.Tensor)
    assert torch.equal(got["w"], torch.from_numpy(st["w"]))
    assert np.array_equal(got["opt"]["mu"], st["opt"]["mu"])
    assert got["opt"]["step"] == 7 and got["b"].dtype == np.int32
    want, rstep, rextra = ref.checkpoint.restore(str(tmp_path), st)
    assert (rstep, rextra) == (step, extra)
    assert np.array_equal(np.asarray(want["b"]), got["b"])


def test_checkpoint_keep_tmp_and_stale_meta(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, {"a": np.zeros(1)})
    for step in range(1, 6):
        ckpt.save(d, step, {"a": np.full(2, step)}, keep=2)
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) \
        == ["step_00000004.npz", "step_00000005.npz"]
    # a torn write is never taken for a checkpoint
    (tmp_path / "tmp.9.npz").write_bytes(b"partial")
    assert ckpt.latest_step(d) == 5
    st, step, _ = ckpt.restore(d, {"a": np.zeros(2, np.int64)})
    assert step == 5 and st["a"].tolist() == [5, 5]
    # meta.json one step behind (crash between the two replaces): the npz
    # scan is authoritative and the stale extra is not paired with it
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"latest_step": 4, "extra": {"x": 1}}, f)
    assert ckpt.latest_step(d) == 5
    assert ckpt.restore(d, {"a": np.zeros(2)})[2] == {}
    assert ckpt.restore(d, {"a": np.zeros(2)}, step=4)[2] == {"x": 1}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_search_snapshot_restores_across_packages(ref, tmp_path, writer):
    rng = np.random.default_rng(8)
    rng.random(3)
    arrays = {"cores": np.arange(12, dtype=np.int32).reshape(3, 4),
              "perm": rng.permutation(20).astype(np.int32)[None, :],
              "times": rng.random(3)}
    arrays["tried_buf"], arrays["tried_lens"] = R.encode_bytes_set(
        {b"ab", b"c"})
    meta = {"engine": "numpy", "rng_state": R.rng_state(rng),
            "evals_used": 30, "history": [{"generation": 0}]}
    mods = {"port": R, "reference": ref.resilience}
    mods[writer].SearchCheckpointer(str(tmp_path), keep=2).save(3, arrays,
                                                                meta)
    for reader in mods.values():
        cp = reader.SearchCheckpointer(str(tmp_path))
        assert cp.latest() == 3 and cp.due(4, 10) and cp.due(10, 10)
        got, gen, got_meta = cp.restore()
        assert gen == 3 and got_meta == json.loads(json.dumps(meta))
        assert sorted(got) == sorted(arrays)
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    with open(tmp_path / "meta.json") as f:
        assert json.load(f)["extra"] == {"generation": 3, "engine": "numpy"}
    assert R.SearchCheckpointer(str(tmp_path / "none")).restore() is None
    with pytest.raises(ValueError, match="reserved"):
        R.SearchCheckpointer(str(tmp_path)).save(
            4, {"_meta_json": np.zeros(1)}, meta)
