"""The program's own spans read as per-layer metrics
(``bench/program_spans.py``): a CPU rehearsal of each cell at smoke size
reads those whose spans exist there, and leaves every reading of the
harness's own as it was; on the card all seven read."""

from __future__ import annotations

import pytest

from bench import harness, program_spans
from bench.conftest import CELLS, smoke_cell

SEED = 2**31 + 23
HOST = ("frontend.draw_s", "compute.pack_s", "network.neuron_ms_per_step",
        "compute.self_ms_per_step")
CUDA_ONLY = ("event_matmul.bind_ms_per_step",
             "event_matmul.launch_ms_per_step",
             "event_matmul2.live_tile_share")


@pytest.mark.parametrize("workload", CELLS)
def test_traced_rehearsal_reads_the_host_spans(workload):
    result, checks, rec = program_spans.run(smoke_cell(workload), SEED, 0.2,
                                            True, device="cpu")
    assert result["correct"] is True, checks
    spans = result["program_spans"]
    for name in HOST:
        assert spans[name] > 0, name
    # no kernel launches on the CPU
    assert set(spans) & set(program_spans.METRICS) == set(HOST)
    assert set(program_spans.METRICS) == set(HOST + CUDA_ONLY)
    assert spans["window_packs"] == 0
    # with no launch spans the compute calls' self time is their total
    assert spans["compute.self_ms_per_step"] == pytest.approx(
        spans["compute_ms_per_step"], rel=1e-9)
    assert spans["compute_ms_per_step"] < spans["run_batch_ms_per_step"]
    # set-up's requests and the window's, then the checked and traced ones
    tr = smoke_cell(workload).traffic
    k = tr["streams_per_job"]
    assert rec.requests >= k * (tr["warm_jobs"] + result["timing"]["jobs"]
                                + 3 * tr["trace_jobs"])


@pytest.mark.parametrize("workload", CELLS)
def test_recording_leaves_the_harness_readings_alike(workload):
    plain, _ = harness.run_cell(smoke_cell(workload), SEED, 0.2, True,
                                device="cpu")
    traced, _, _ = program_spans.run(smoke_cell(workload), SEED, 0.2, True,
                                     device="cpu")
    assert set(traced["metrics"]) == set(plain["metrics"])
    for name, m in traced["metrics"].items():
        assert m["unit"] == plain["metrics"][name]["unit"]
        assert type(m["value"]) is type(plain["metrics"][name]["value"])
    assert traced["checks"] == plain["checks"]


@pytest.mark.chip
def test_all_seven_read_on_the_card(cuda_device):
    """On the card, at the published widths: every metric reads, the
    live-tile share lies in (0, 100], the compute calls' self time and
    the wrapper's bind and launch spans add up to the compute calls'
    total, and the idle gaps inside the calls carry the wrapper's span
    names."""
    cell = harness.find_cell("whisper-base.decode448")
    result, checks, _ = program_spans.run(cell, SEED, 2.0, True)
    assert result["correct"] is True, checks
    spans = result["program_spans"]
    for name in program_spans.METRICS:
        assert spans[name] > 0, name
    assert spans["event_matmul2.live_tile_share"] <= 100
    parts = (spans["compute.self_ms_per_step"]
             + spans["event_matmul.bind_ms_per_step"]
             + spans["event_matmul.launch_ms_per_step"])
    assert parts == pytest.approx(spans["compute_ms_per_step"], rel=1e-6)
    labels = {g[0].split(":")[0] for g in result["breakdown"]["idle_gaps"]}
    assert labels & {"event_matmul.bind", "event_matmul.launch"}, labels
