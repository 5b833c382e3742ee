"""Fixtures of the benchmark's CPU tests, and the ``chip`` marker for the
tests that need a CUDA card (they skip without one, decided in the
``cuda_device`` fixture, never at import)."""

from __future__ import annotations

import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: The port's smoke configs of the two architectures, as configuration
#: objects (``repro_torch.configs.{whisper_base,mamba2_1_3b}.smoke``).
SMOKE_CONFIGS = {
    "whisper-base": dict(
        name="whisper-smoke", kind="encdec", d_model=32, n_heads=4,
        n_kv_heads=4, head_dim=8, vocab_size=256, d_ff=64, n_enc_layers=2,
        n_dec_layers=2, n_frames=12),
    "mamba2-1.3b-6of48": dict(
        name="mamba2-smoke", kind="lm", d_model=32, n_heads=1,
        n_kv_heads=1, head_dim=1, vocab_size=256, n_repeats=2,
        pattern=[{"kind": "ssd", "d_ff": 0,
                  "ssd": {"d_inner": 64, "head_dim": 16, "d_state": 16,
                          "n_groups": 1, "chunk": 8}}]),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


#: A rehearsal's share of a run: short streams, two a job, one warm and
#: one traced job (the mix's context, neuron model and densities stay).
REHEARSAL = {"steps": 64, "streams_per_job": 2, "warm_jobs": 1,
             "trace_jobs": 1}


#: Every cell kept in ``bench/``'s files (``bench/limits/<cell>.json``),
#: whether ``BENCHMARK.json`` lists it or not.
CELLS = sorted(p.stem for p in (ROOT / "bench" / "limits").glob("*.json"))


def smoke_cell(name: str, **traffic_overrides):
    """The cell ``name`` with the port's smoke config of its architecture
    in place of the published one, at a rehearsal's share of a run."""
    from bench import harness
    cell = harness.file_cell(name, ROOT)
    cell.config = SMOKE_CONFIGS[cell.config["name"]]
    cell.traffic = {**cell.traffic, **REHEARSAL, **traffic_overrides}
    return cell


@pytest.fixture
def benchmark_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
