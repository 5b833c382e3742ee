"""The harness's contract on the CPU: it loads neither JAX nor the JAX
package, refuses to run without a card, finds configurations, traffic
mixes and metrics added as new files, and (on a card only) proves a cell
correct at its published size."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench import harness
from bench.conftest import CELLS, ROOT, smoke_cell

#: One thread a subprocess: the tests run beside other workers.
ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "src")])}


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("workload", CELLS)
def test_a_rehearsal_loads_no_jax(workload):
    """In a fresh process, after a whole rehearsal run (window, traced
    window, reference), no module's top-level name is jax, jaxlib, flax,
    repro or benchmarks (whole names: repro_torch is the program)."""
    code = (
        "import json\n"
        "from bench import harness\n"
        "from bench.conftest import smoke_cell\n"
        f"cell = smoke_cell({workload!r})\n"
        "for trace in (False, True):\n"
        "    result, _ = harness.run_cell(cell, 5, 0.2, trace, "
        "device='cpu')\n"
        "    assert result['correct'], result\n"
        "import sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reprox", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like.core", sys)
    found = harness.forbidden_modules()
    assert set(found) <= set(harness.FORBIDDEN)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


def _copy_bench(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_run_without_a_card_fails_and_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without")
    for root in (ROOT, tmp_path):
        if root == tmp_path:        # only BENCHMARK.json and bench/
            _copy_bench(tmp_path)
        proc = subprocess.run(
            [sys.executable, "bench/run.py", "--workload",
             "whisper-base.decode448", "--seed", str(2**31 + 3),
             "--seconds", "1", "--trace", "0"], cwd=root,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
            capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert proc.stdout == ""


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer
    metric added as new files, with new entries in BENCHMARK.json, make a
    new cell; no file that was there is edited."""
    _copy_bench(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = dict(smoke_cell("whisper-base.decode448").config,
               name="tiny-encdec")
    (tmp_path / "bench" / "configs" / "tiny-encdec.json").write_text(
        json.dumps(cfg))
    (tmp_path / "bench" / "traffic" / "short24.json").write_text(
        json.dumps({"steps": 24, "seq_len": 16, "recurrent_neuron": "ssm",
                    "streams_per_job": 2, "warm_jobs": 1}))
    (tmp_path / "bench" / "limits" / "tiny-encdec.short24.json").write_text(
        json.dumps({"out_gap": 1e-4}))
    # a neuron model of the reference, found by the name the layer has
    relu = (tmp_path / "bench" / "neurons" / "relu.py")
    relu.write_text(relu.read_text() + "\n_messages = messages\n\n\n"
                    "def messages(layer, pre):\n"
                    "    import pathlib\n"
                    "    pathlib.Path(__file__).with_suffix('.ran')"
                    ".write_text(layer.spec.name)\n"
                    "    return _messages(layer, pre)\n")
    (tmp_path / "bench" / "metrics" / "jobs.window_count.py").write_text(
        "def read(run):\n    return float(run.window_jobs)\n")
    bench["configs"].append({"name": "tiny-encdec", "source": "test",
                             "file": "bench/configs/tiny-encdec.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-encdec.short24",
                               "config": "tiny-encdec",
                               "traffic": "short24", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "jobs.window_count", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "simulation job",
                               "moves": "sim_steps_per_s",
                               "workloads": ["tiny-encdec.short24"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell("tiny-encdec.short24", tmp_path)
    assert cell.config["name"] == "tiny-encdec"
    assert cell.traffic["steps"] == 24
    assert "jobs.window_count" in [m["name"] for m in cell.per_layer]
    assert "jobs.window_count" not in [
        m["name"] for m in harness.find_cell("whisper-base.decode448",
                                             tmp_path).per_layer]
    result, checks = harness.run_cell(cell, 9, 0.2, True, device="cpu")
    assert result["correct"] is True, checks
    assert result["metrics"]["jobs.window_count"]["value"] >= 1
    assert relu.with_suffix(".ran").read_text() == "head"


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_at_published_size_and_control_is_not(
        workload, cuda_device):
    """On the card: a short run of the cell at its published widths is
    correct, and the control (the reference in TF32 in the program's
    place) is not, on the same seed."""
    from bench import readings
    row = readings.readings(harness.file_cell(workload), 2**31 + 17)
    assert row["correct"] is True, row
    assert row["control"]["correct"] is False, row
    assert row["checks"]["counter_mismatch"]["value"] == 0
