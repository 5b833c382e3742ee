"""The bytes of the ssm state neurons' scan (``bench/scan_counting.py``)
and their reader, ``ssm_scan_roofline``, on the CPU."""

from __future__ import annotations

import dataclasses

import pytest

from bench import counting, harness, scan_counting
from bench.conftest import ROOT, smoke_cell

CELL = "mamba2-1.3b-6of48.ssm1024"


def _cell():
    return harness.find_cell(CELL, ROOT)


def test_full_size_bytes():
    """Six state layers of 4,096 neurons over 1,024 steps: each reads its
    pre-activations and writes its messages once, and reads and writes
    its state once; two traced jobs of one stream."""
    cell = _cell()
    assert (cell.config["n_repeats"], cell.traffic["steps"]) == (6, 1024)
    per_stream = 6 * (2 * 1024 * 4096 * 4 + 2 * 4096 * 4)
    assert scan_counting.stream_bytes(cell.config, cell.traffic) \
        == per_stream == 201_523_200
    assert scan_counting.traced_bytes(cell.config, cell.traffic) \
        == 2 * 1 * per_stream
    # 10.0 us a layer and stream at the card's bandwidth
    layer_s = (2 * 1024 * 4096 * 4) / counting.PEAK_BYTES_PER_S
    assert layer_s == pytest.approx(10.0e-6, rel=2e-3)


def test_only_ssm_layers_count():
    cell = _cell()
    sd = dict(cell.traffic, recurrent_neuron="sd_relu")
    assert scan_counting.stream_bytes(cell.config, sd) == 0
    whisper = harness.find_cell("whisper-base.decode448", ROOT)
    assert scan_counting.stream_bytes(whisper.config, whisper.traffic) == 0


class _Profile:
    def __init__(self, by_name: dict):
        self.by_name = by_name

    def device_seconds(self, parts):
        return sum(s for n, s in self.by_name.items()
                   if any(p in n for p in parts))


def _run(cell, profile):
    return harness.Run(cell=cell, steps=1024, spans=None, job_s=[],
                       window_jobs=0, window_s=1.0, macs_per_job=None,
                       profile=profile, needs=[])


def test_reader_reads_the_kernels_device_time():
    read = harness.load_reader("ssm_scan_roofline", ROOT)
    cell = _cell()
    nbytes = scan_counting.traced_bytes(cell.config, cell.traffic)
    at_bound = nbytes / counting.PEAK_BYTES_PER_S
    prof = _Profile({"void (anonymous namespace)::ssm_scan_kernel<true>":
                     2 * at_bound, "event_matmul_kernel": 1.0})
    assert read(_run(cell, prof)) == pytest.approx(50.0)


@pytest.mark.parametrize("profile", [None, _Profile({}), _Profile(
    {"event_matmul_kernel": 1.0})], ids=["no_profile", "empty",
                                         "no_scan_kernel"])
def test_reader_finds_nothing_without_a_profile_or_the_kernel(profile):
    read = harness.load_reader("ssm_scan_roofline", ROOT)
    assert read(_run(_cell(), profile)) is None


def test_reader_finds_nothing_in_a_cell_without_ssm_layers():
    read = harness.load_reader("ssm_scan_roofline", ROOT)
    cell = dataclasses.replace(
        _cell(), traffic=dict(_cell().traffic, recurrent_neuron="sd_relu"))
    assert read(_run(cell, _Profile({"ssm_scan_kernel": 1.0}))) is None


def test_the_metric_is_the_new_cells_alone():
    names = lambda c: [m["name"] for m in c.per_layer]
    assert "ssm_scan_roofline" in names(_cell())
    assert "ssm_scan_roofline" in names(smoke_cell(CELL))
    assert "ssm_scan_roofline" not in names(
        harness.find_cell("whisper-base.decode448", ROOT))
