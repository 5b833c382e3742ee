"""The GPU smoke script's search phases (o) to (q), rehearsed on the CPU.

``chip_smoke.search_phases`` applies the committed trained profile to a
cell, runs ``greedy_then_evolve`` with both population backends, kills and
resumes each search and scripts one demotion, checking every step itself.
Here it runs on a narrow copy of the smoke's slice-1 cell (same depth,
neuron model and densities), where every kernel wrapper runs its plain
version and so launches nothing.

Phase (o) requires the kernel-mode counters to equal the dense backend's.
With float32 weights that holds only where no pre-activation lies within
roundoff of a rounding step of the sigma-delta quantiser: on this narrow
cell, at threshold 0.05, the JAX package's own event and dense backends
differ by a few of fc1's messages.  So the copy's weights, inputs and
threshold are multiples of 1/8: every message is then a multiple of 1/8,
every sum is exact in float32, and any summation order gives the same
counters."""

from __future__ import annotations

import importlib.util
import json
import pathlib

import torch

from repro_torch.neuromorphic import (SimLayer, SimNetwork, fc_network,
                                      loihi2_like, make_inputs)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _eighths(t: torch.Tensor) -> torch.Tensor:
    """``t`` with each nonzero entry rounded to a nonzero multiple of 1/8
    (zeros, and so densities, kept)."""
    q = torch.clamp(torch.round(t.abs() * 8), min=1) / 8
    return torch.where(t != 0, torch.sign(t) * q, t)


def test_search_phases_pass_on_a_narrow_cell(tmp_path, capsys):
    smoke = _chip_smoke()
    sizes = [32, 64, 32, 32, 16]
    base = fc_network(sizes, weight_density=0.5, neuron_model="sd_relu",
                      seed=0, device="cpu")
    net = SimNetwork(layers=[SimLayer(name=l.name, kind="fc",
                                      weights=_eighths(l.weights),
                                      neuron_model="sd_relu")
                             for l in base.layers], in_size=sizes[0])
    for layer in net.layers:
        layer.threshold = 0.125
    # T past the 128-step delta window, as in the smoke's cell
    xs = _eighths(make_inputs(sizes[0], density=0.1, steps=160, seed=1,
                              device="cpu"))
    smoke.search_phases(net, xs, loihi2_like(), ckpt_root=tmp_path / "ckpt",
                        expect_launches={"event_matmul2": 0,
                                         "window_cumsum": 0},
                        card="cpu",
                        search=dict(population_size=8,
                                    generations=smoke.KILL_AFTER + 2,
                                    seed=0))
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["phase"] for l in lines] == ["sparsity_profile", "search",
                                           "resume"]
    resume = lines[2]
    assert resume["device_pricer_deterministic"]
    assert {b: r["bit_identical"] for b, r in resume["resume"].items()} \
        == {"numpy": True, "device": True}
    assert [(d["frm"], d["to"]) for d in
            resume["scripted_demotion"]["demotions"]] == [("device", "numpy")]
