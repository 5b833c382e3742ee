"""Rehearsals of the benchmark's cells on the CPU, with the port's smoke
configs of both architectures under each traffic mix (the kernel
wrappers run their plain versions there): the port's counters equal the
reference's exactly and its outputs agree within the cells' limits; the
control (the reference in TF32) and planted faults fail the check."""

from __future__ import annotations

import json

import pytest
import torch

from bench import harness
from bench.conftest import CELLS as WORKLOADS
from bench.conftest import REHEARSAL, ROOT, smoke_cell

TRAFFIC = sorted(p.stem for p in (ROOT / "bench" / "traffic").glob("*.json"))
SEED = 2**31 + 11


def _run(cell, trace=False, seed=SEED, seconds=0.2, control=False):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            control=control)


@pytest.mark.parametrize("mix", TRAFFIC)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_counters_exact_and_outputs_within_limits(workload, mix):
    mix = json.loads((ROOT / "bench" / "traffic" / f"{mix}.json")
                     .read_text())
    cell = smoke_cell(workload, **{**mix, **REHEARSAL})
    result, checks = _run(cell)
    assert checks["counter_mismatch"]["value"] == 0
    assert checks["layer_mismatch"]["value"] == 0
    assert checks["out_gap"]["value"] <= checks["out_gap"]["limit"]
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"sim_steps_per_s", "job_p90_s",
                                      "setup_s"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reports_the_host_metrics(workload):
    cell = smoke_cell(workload)
    result, _ = _run(cell, trace=True)
    assert result["correct"] is True
    names = set(result["metrics"])
    assert {"frontend.compile_s", "sim_step.mfu", "network.self_ms_per_step",
            "compute.host_ms_per_step"} <= names
    # no device on the CPU: the device readers find nothing to read
    assert "event_matmul2_roofline" not in names
    assert result["device"]["window_s"] > 0
    mfu = result["metrics"]["sim_step.mfu"]["value"]
    assert 0 < mfu < 100


@pytest.mark.parametrize("seed", [3, 4, 2**31 + 5])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limit(workload, seed):
    """The reference in TF32, put in the program's place, goes through
    the run's own checks and is not correct; the program is."""
    result, checks = _run(smoke_cell(workload), seed=seed,
                          control=True)
    control = result["control"]["checks"]
    assert result["correct"] is True
    assert result["control"]["correct"] is False
    assert checks["out_gap"]["value"] < checks["out_gap"]["limit"] \
        < control["out_gap"]["value"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_ragged_head_rehearsal(workload):
    """A vocabulary that is no multiple of the kernel's tile or of 8, as
    the published ones are not (51,865; 50,277), runs and is correct."""
    cell = smoke_cell(workload)
    cell.config = {**cell.config, "vocab_size": 259}
    result, checks = _run(cell, trace=True)
    assert result["correct"] is True, checks
    assert 0 < result["metrics"]["sim_step.mfu"]["value"] < 100


def _fault_state_unchanged(monkeypatch):
    from repro_torch.neuromorphic.network import SimLayer
    orig = SimLayer._neuron_batch

    def neuron_batch(self, pre, state):
        if self.neuron_model != "ssm":
            return orig(self, pre, state)
        return (pre.abs() + 1.0 if self.force_active else pre), state
    monkeypatch.setattr(SimLayer, "_neuron_batch", neuron_batch)


def _patch_run_batch(monkeypatch, after):
    from repro_torch.neuromorphic.network import SimNetwork
    orig = SimNetwork.run_batch

    def run_batch(self, xs, *, compute=None):
        return after(orig, self, xs, compute)
    monkeypatch.setattr(SimNetwork, "run_batch", run_batch)


def _fault_half_batch(monkeypatch):
    def after(orig, net, xs, compute):
        half = xs.shape[0] // 2
        out, cnts = orig(net, xs[:half], compute=compute)
        pad = lambda t: torch.cat([t, torch.zeros((xs.shape[0] - half,)
                                                  + t.shape[1:],
                                                  dtype=t.dtype)])
        for c in cnts:
            for name in ("msgs_in", "macs", "fetches_dense", "msgs_out",
                         "acts_evented"):
                setattr(c, name, pad(getattr(c, name)))
        return pad(out), cnts
    _patch_run_batch(monkeypatch, after)


def _fault_answer_altered(monkeypatch):
    def after(orig, net, xs, compute):
        out, cnts = orig(net, xs, compute=compute)
        out = out.clone()
        out[out.shape[0] // 2, 0] *= 1.001
        return out, cnts
    _patch_run_batch(monkeypatch, after)


def _fault_counter_altered(monkeypatch):
    def after(orig, net, xs, compute):
        out, cnts = orig(net, xs, compute=compute)
        cnts[len(cnts) // 2].macs[0, 0] += 1
        return out, cnts
    _patch_run_batch(monkeypatch, after)


FAULTS = {"state_unchanged": _fault_state_unchanged,
          "half_batch": _fault_half_batch,
          "answer_altered": _fault_answer_altered,
          "counter_altered": _fault_counter_altered}


def _keeps_state(workload: str) -> bool:
    """Whether the cell's network has state layers (SSD blocks)."""
    cfg = smoke_cell(workload).config
    return any(b.get("ssd") for b in cfg.get("pattern", []))


#: Each fault the cell can have: a network without state layers has no
#: state to leave unchanged.
FAULT_CASES = [(w, f) for w in WORKLOADS for f in sorted(FAULTS)
               if f != "state_unchanged" or _keeps_state(w)]


@pytest.mark.parametrize("workload,fault", FAULT_CASES)
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    cell = smoke_cell(workload)
    FAULTS[fault](monkeypatch)
    result, checks = _run(cell)
    assert result["correct"] is False, checks
