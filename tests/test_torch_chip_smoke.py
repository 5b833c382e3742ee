"""The GPU smoke script's search phases (o) to (t), rehearsed on the CPU.

``chip_smoke.search_phases`` applies the committed trained profile to a
cell, runs ``greedy_then_evolve`` with both population backends, kills and
resumes each search and scripts one demotion, then holds the device and
sharded search engines to their host mirrors generation by generation,
scripts a demotion of the device engine and kills and resumes it,
checking every step itself.
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

import numpy as np

from repro_torch.neuromorphic import (SimLayer, SimNetwork, fc_network,
                                      loihi2_like, make_inputs,
                                      minimal_partition, ordered_mapping,
                                      random_mapping, strided_mapping)
from repro_torch.neuromorphic.timestep import precompute_pricing

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_search_phases_pass_on_a_narrow_cell(tmp_path, capsys):
    smoke = _chip_smoke()
    sizes = [32, 64, 32, 32, 16]
    base = fc_network(sizes, weight_density=0.5, neuron_model="sd_relu",
                      seed=0, device="cpu")
    net = SimNetwork(layers=[SimLayer(name=l.name, kind="fc",
                                      weights=smoke.eighths(l.weights),
                                      neuron_model="sd_relu")
                             for l in base.layers], in_size=sizes[0])
    for layer in net.layers:
        layer.threshold = 0.125
    # T past the 128-step delta window, as in the smoke's cell
    xs = smoke.eighths(make_inputs(sizes[0], density=0.1, steps=160,
                                   seed=1, device="cpu"))
    smoke.search_phases(net, xs, loihi2_like(), ckpt_root=tmp_path / "ckpt",
                        expect_launches={"event_matmul2": 0,
                                         "window_cumsum": 0},
                        card="cpu",
                        search=dict(population_size=8,
                                    generations=smoke.KILL_AFTER + 2,
                                    seed=0),
                        throughput=dict(population_size=64, generations=2,
                                        seed=0),
                        islands=dict(n_islands=2, migrate_every=3))
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["phase"] for l in lines] == [
        "sparsity_profile", "search", "resume", "device_search",
        "sharded_search", "device_resilience"]
    resume = lines[2]
    assert resume["device_pricer_deterministic"]
    assert {b: r["bit_identical"] for b, r in resume["resume"].items()} \
        == {"numpy": True, "device": True}
    assert [(d["frm"], d["to"]) for d in
            resume["scripted_demotion"]["demotions"]] == [("device", "vmap")]
    dev, sharded, resil = lines[3:]
    assert dev["backend"] == "device" and dev["threefry_values_checked_vs_cpu"]
    assert dev["max_rel_diff"] <= smoke.SEARCH_RTOL
    assert len(dev["device"]["host_syncs_per_generation"]) \
        == smoke.KILL_AFTER + 3
    assert dev["throughput"]["n_evals"] == 64 * 3
    assert sharded["one_island"]["bit_identical_to_device_engine"]
    assert sharded["islands"]["migrations"] == 2
    assert [(d["frm"], d["to"]) for d in
            resil["scripted_demotion"]["demotions"]] \
        == [("device", "numpy-mirror")]
    assert resil["resume"]["held_to"] == "bit-identical"


def test_training_phases_pass_at_small_widths(tmp_path, capsys):
    """Phases (u) to (w) on the CPU at small widths: train, guide, prune,
    kill and resume; extract, deploy, run and search each trained network;
    calibrate a sigma-delta network and run it.

    The sigma-delta run here stays inside one 128-step delta window (96
    rows), where kernel mode sums each delta layer's input as dense does.
    Past the window the windowed reconstruction sums in another order, and
    on layers this narrow one quantiser tie moves a layer's few hundred
    messages by more than the phase's rtol of 1e-3 (ROADMAP §3); the card
    runs (w) past the window at full width."""
    smoke = _chip_smoke()
    smoke.training_phases(
        device="cpu", card="cpu", ckpt_root=tmp_path / "train",
        sizes=(32, 48, 32, 32, 10),
        train=dict(steps=12, batch=16, seed=0, lam=0.05, prune_sparsity=0.5,
                   finetune_steps=6),
        kill=8, cpu_steps=5, probe_steps=4,
        iso_search=dict(population_size=8, generations=3, seed=0),
        denoise_sizes=(16, 24, 16, 16, 16), denoise_steps=10, sd_steps=96)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["phase"] for l in lines] == [
        "sparsity_training", "iso_accuracy", "sigma_delta_training"]
    u, v, w = lines
    assert u["steps"] == {"dense": 12, "guided": 18}
    assert u["kill_and_resume"] == {"killed_at": 8, "bit_identical": True}
    assert u["first_losses_vs_cpu"]["max_diff_over_first_loss"] == 0.0
    assert u["init_vs_host_draw"]["differing"] == 0
    assert u["sqrt_f32_values_differing_from_host"] == [0, 1 << 22]
    assert u["masks_kept"] == [768, 768, 512, 160]
    assert len(u["guidance_weights"]) == 3
    assert [r["config"] for r in v["rows"]] == ["dense",
                                               "tl1[0.05]+prune0.5"]
    assert v["launches_per_run_batch"] == {
        k: {"event_matmul2": 0, "window_cumsum": 0} for k in
        ("dense", "tl1[0.05]+prune0.5")}
    assert all(r["n_evals"] > 0 and r["time"] > 0 for r in v["rows"])
    assert isinstance(v["iso_ok"], bool)
    assert v["profile_injection"]["arch"] == "gemma2-2b"
    assert v["profile_injection"]["time_ratio"] > 0
    assert w["held_out_rows"] == 96 and len(w["thresholds"]) == 4
    assert w["counters"] == "bit-identical to dense"
    assert w["thresholds_vs_cpu_max_rel_diff"] == 0.0
    assert w["launches"] == {"event_matmul2": 0, "window_cumsum": 0}


def test_serve_phases_pass_on_smoke_configs(capsys):
    """Phases (x) to (z) on the CPU with gemma2's and whisper's smoke
    configs in place of the full ones: serve greedy and sampled, hold the
    engine to teacher forcing on a short prompt, one crossing the window
    (5 + 10 tokens past gemma2-smoke's 8) and a chunked prefill (5120
    tokens), then the card's place taken by the host (so every card-host
    difference is 0)."""
    smoke = _chip_smoke()
    smoke.serve_phases(device="cpu", card="cpu", full=False,
                       serve_args=dict(batch=4, prompt_len=12, new_tokens=6),
                       trace_steps=3,
                       check_prompts=((12, 4), (5, 10), (5120, 2)),
                       family_steps=4, whisper_steps=6)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["phase"] for l in lines] == ["serve", "serve_check",
                                           "serve_families"]
    x, y, z = lines
    assert x["arch"] == "gemma2-smoke" and x["greedy_repeats"]
    assert len(x["decode_ms_steps"]) == 5 and x["decode_ms_per_token"] > 0
    assert x["ported_kernel_launches"] == {
        k: 0 for k in ("event_matmul2", "window_cumsum", "flash_attn",
                       "event_matmul", "sigma_delta")}
    assert x["sampled"]["identical_twice"] and len(x["sampled"]["row0"]) == 6
    assert set(x["scalar_vs_true_division_differing_of_2e20"].values()) \
        == {0}
    assert [(r["crosses_window"], r["chunked_prefill"]) for r in
            y["prompts"]] == [(False, False), (True, False), (False, True)]
    assert all(r["tokens_equal_teacher_forcing"] and
               r["max_abs_logit_diff"] <= y["tol"] for r in y["prompts"])
    assert len(z["smoke_configs"]) == 10
    assert all(r["tokens_equal"] for r in z["smoke_configs"].values())
    assert z["whisper"]["max_abs_logit_diff_vs_decode_train"] <= 2e-3


def test_lm_train_phases_pass_on_smoke_configs(tmp_path, capsys):
    """Phases (A) to (D) on the CPU with gemma2's smoke config in place of
    the full one: train through the launcher, check the gradient along
    random directions against central differences, hold the card (here
    the host again) to the host on every smoke config, and kill, resume
    and recover the granite trainer."""
    smoke = _chip_smoke()
    smoke.lm_train_phases(device="cpu", card="cpu", full=False,
                          ckpt_root=tmp_path / "lm",
                          train=dict(steps=4, batch=2, seq=32, lr=1e-2),
                          trace_steps=1,
                          grad_check=dict(batch=1, seq=16, seed=0,
                                          scale=0.02, loss_change=1e-3,
                                          halvings=6))
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [l["phase"] for l in lines] == [
        "lm_train", "lm_grad_check", "lm_train_families", "lm_resume"]
    a, b, c, d = lines
    zero = {k: 0 for k in ("event_matmul2", "window_cumsum", "flash_attn",
                           "event_matmul", "sigma_delta")}
    assert a["arch"] == "gemma2-smoke" and a["optimizer"] == "adamw"
    assert len(a["loss_curve"]) == 4
    assert a["loss_curve"][-1] < a["loss_curve"][0]
    assert a["mfu"] > 0 and a["step_bound"]["bound_ms"] > 0
    assert a["ported_kernel_launches"] == zero
    assert set(b["checks"]) == {"all", "embed", "attention", "mlp", "norms"}
    assert all(r["rel_err"] <= b["tol"] for r in b["checks"].values())
    assert len(c["smoke_configs"]) == 10
    assert all(r["loss_abs_diff"] == 0 and r["grad_max_abs_diff"] == 0
               for r in c["smoke_configs"].values())
    assert c["granite"]["compressed"]["err_share_beyond_atol"] == 0
    assert c["ported_kernel_launches"] == zero
    assert d["kill_and_resume"]["resumed_from"] == 8
    assert d["kill_and_resume"]["held_to"] == "bit-identical"
    assert d["fault"]["recoveries"][0][0] == 6
    assert len(d["fault"]["recoveries"]) == 1
    assert d["fault"]["held_to"] == "bit-identical"


def test_bound_and_dryrun_phases_pass_on_smoke_configs(capsys):
    """Phases (E) and (F) on the CPU with the smoke configs in place of
    the full ones: count gemma2's step on the host's tensors and on meta
    (the same FLOPs), count and time olmoe's and mamba2's steps, then the
    dry-run's train cells on meta and a hillclimb over gemma2's.  (A)'s
    result is stood in for: a step of 1 s at batch 2 x 32."""
    from repro_torch.configs import registry
    smoke = _chip_smoke()
    cfg = registry.get("gemma2-2b").smoke()
    lm_a = {"step_s": 1.0, "peak_device_bytes": "not measured",
            "device_bytes_held_before": "not measured",
            "step_bound": smoke.lm_step_bound(cfg, 2, 32), "batch": 2,
            "seq": 32}
    smoke.step_bound_phases(device="cpu", card="cpu", lm_a=lm_a, full=False)
    smoke.dryrun_phases(card="cpu", full=False)
    out = capsys.readouterr().out.splitlines()
    lines = [json.loads(l) for l in out if l.startswith("{")]
    assert [l["phase"] for l in lines] == ["step_bound", "dryrun"]
    e, f = lines
    zero = {k: 0 for k in ("event_matmul2", "window_cumsum", "flash_attn",
                           "event_matmul", "sigma_delta")}
    g = e["gemma2"]
    assert g["arch"] == "gemma2-smoke" and g["meta_count_equals_card_count"]
    assert g["terms"]["bound_s"] > 0 and g["terms"]["t_collective_s"] == 0
    assert g["step_over_counted_bound"] == 1.0 / g["terms"]["bound_s"]
    assert g["meta_peak_bytes"] > g["meta_argument_bytes"] > 0
    assert g["measured_peak_bytes_less_held"] == "not measured"
    assert sorted(e["others"]) == ["mamba2-1.3b", "olmoe-1b-7b"]
    for r in e["others"].values():
        assert len(r["step_s"]) == 2 and r["step_over_bound"] > 0
        assert r["terms"]["flops"] > 0
    assert e["ported_kernel_launches"] == f["ported_kernel_launches"] == zero
    assert sorted(f["cells"]) == [f"{a}|train_4k" for a in registry.ARCH_IDS]
    assert all(r["fits"] and r["bound_s"] > 0 for r in f["cells"].values())
    assert f["hillclimb"]["steps"] >= 1
    assert any(l.startswith("| # | move |") for l in out)


def test_option_and_vmap_phases_pass_at_small_widths(capsys):
    """Phases (G) and (H) on the CPU: each of ``EventCompute``'s option
    sets in kernel mode (the plain versions here, so no launch) against
    gather mode on a narrow copy of the slice-1 cell on the 1/8 grid, past
    the 128-step window; then a population priced with the vmap, device
    and numpy backends and one scripted demotion, device to vmap."""
    smoke = _chip_smoke()
    g = smoke.event_options_phase(device="cpu", card="cpu",
                                  sizes=(32, 64, 32, 32, 16), T=320, reps=1)
    assert list(g["options"]) == [n for n, _ in smoke.EVENT_OPTIONS]
    windows = {n: r["window"] for n, r in g["options"].items()}
    assert windows == {"delta_window=16": 16, "delta_window=32": 32,
                       "delta_mode=cumsum": None, "threshold=0.05": 128,
                       "bm=bk=64": 64}
    for row in g["options"].values():
        assert row["launches"] == {"event_matmul2": 0, "window_cumsum": 0}
        assert row["outputs_max_abs_err"] == 0.0
    assert sum(g["options"]["delta_window=16"]["msgs_out_per_layer"]) > 0
    net = SimNetwork(layers=[SimLayer(name=l.name, kind="fc",
                                      weights=smoke.eighths(l.weights),
                                      neuron_model="sd_relu")
                             for l in fc_network([32, 64, 32, 32, 16],
                                                 weight_density=0.5,
                                                 neuron_model="sd_relu",
                                                 seed=0,
                                                 device="cpu").layers],
                     in_size=32)
    xs = smoke.eighths(make_inputs(32, density=0.1, steps=40, seed=1,
                                   device="cpu"))
    chip = loihi2_like()
    p0 = minimal_partition(net, chip)
    rng = np.random.default_rng(3)
    parts = [p0, p0.split(0), p0.split(1).split(2)]
    cands = [(p, mk(p, chip)) for p in parts
             for mk in (ordered_mapping, strided_mapping)]
    cands += [(p, random_mapping(p, chip, rng)) for p in parts]
    h = smoke.vmap_pricing_phase(net, xs, chip,
                                 cache=precompute_pricing(net, xs, chip),
                                 cands=cands, card="cpu")
    assert h["candidates"] == 9
    assert max(h["max_rel_diff_vs_numpy"].values()) <= smoke.POP_RTOL
    assert [(d["frm"], d["to"]) for d in
            h["scripted_demotion"]["demotions"]] == [("device", "vmap")]
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["phase"] for l in lines] == ["event_options", "vmap_pricing"]



def test_data_parallel_phases_pass_over_a_one_rank_group(tmp_path, capsys):
    """Phase (I) on the CPU over a one-rank gloo group, with the smoke
    configs in place of the full ones: the exact DP step bit-identical to
    the step without a group, the compressed step, the EP olmoe loss and
    gradients bit-identical to the path without a group, four islands
    over the group held to the one-program run, and an asynchronous
    checkpoint restored bit-identical to a synchronous one.  (A)'s result
    is stood in for: a step of 1 s."""
    smoke = _chip_smoke()
    net = fc_network([32, 64, 32, 16], weight_density=0.5,
                     neuron_model="sd_relu", seed=0, device="cpu")
    xs = make_inputs(32, density=0.1, steps=24, seed=1, device="cpu")
    chip = loihi2_like()
    ctx = dict(pnet=net, xs=xs, chip=chip,
               cache=precompute_pricing(net, xs, chip), greedy=None,
               search=dict(population_size=8, generations=4, seed=0),
               islands=dict(n_islands=4, migrate_every=2))
    smoke.data_parallel_phases(
        device="cpu", card="cpu", ckpt_root=tmp_path / "dp",
        lm_a={"step_s": 1.0}, islands_ctx=ctx, full=False,
        train=dict(batch=2, seq=32, lr=1e-2), dp_steps=2,
        async_ckpt=dict(save_at=2, steps=3))
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [l["phase"] for l in lines] == [
        "dp_train", "dp_expert_parallel", "dp_islands",
        "dp_async_checkpoint"]
    a, b, c, d = lines
    assert a["backend"] == "gloo" and a["world"] == 1
    assert a["exact_dp_bit_identical_to_no_group"]
    # float32 smoke config: the error tree is the gradient tree's size
    assert a["dtype"] == "float32"
    assert a["error_feedback_bytes"] == a["gradient_bytes"] > 0
    assert len(a["step_s"]["compressed_dp"]) == 2
    assert b["loss_and_grads_bit_identical_to_no_group"]
    assert b["metrics"]["max_expert_load"] > 0
    assert c["genomes_identical_every_snapshot"] == 5
    assert not c["held_to_phase_s_snapshots"]
    assert d["restore_bit_identical_to_sync_save"]
    assert len(d["step_s_during_write"]) + len(d["step_s_after_write"]) == 3


def test_tensor_parallel_phases_pass_over_a_one_rank_group(tmp_path, capsys):
    """Phase (J) on the CPU over a one-rank gloo group, with the smoke
    configs in place of the full ones: the engine over the model group
    serves phase (x)'s tokens (stood in for by the same launcher's engine
    without a group), the launcher's trainer on a (1, 1) mesh is
    bit-identical to the one without a group, the collectives of a decode
    step and a train step equal the count derived from the code, and the
    PerfFlags and the other block kinds hold."""
    from repro_torch.launch import serve
    smoke = _chip_smoke()
    serve_args = dict(batch=2, prompt_len=12, new_tokens=4)
    _, eng, prompts = serve.build(serve.parse_args(
        ["--arch", smoke.SERVE_ARCH, "--batch", "2", "--prompt-len", "12",
         "--new-tokens", "4", "--device", "cpu", "--smoke"]))
    serve_x = {"tokens": eng.generate(prompts), "decode_ms": 1.0}
    smoke.tensor_parallel_phases(
        device="cpu", card="cpu", ckpt_root=tmp_path / "tp",
        serve_x=serve_x, full=False, serve_args=serve_args,
        train=dict(batch=2, seq=32, lr=1e-2), steps=2)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [l["phase"] for l in lines] == [
        "tp_serve", "tp_train", "tp_collectives", "tp_flags"]
    a, b, c, d = lines
    assert a["backend"] == "gloo" and a["tokens_equal_phase_x"]
    assert b["loss_and_params_bit_identical_to_no_group"]
    assert len(b["losses"]) == 2
    # gemma2-smoke: 4 blocks, all repeated under remat
    assert c["expected_from_code"] == {
        "decode": {"psum": 17, "gather_from": 13, "pmax": 4},
        "train": {"psum": 19, "pmax": 1, "copy_to.grad": 9}}
    assert c["measured"] == c["expected_from_code"]
    assert [r["config"] for r in d["full_width_bit_identical"]] == [
        "gemma2-smoke", "olmoe-smoke"]
    assert [r["config"] for r in d["smoke_card_vs_host"]] == [
        "olmoe-smoke", "mamba2-smoke", "rg-smoke"]


def test_init_phase_passes_on_smoke_configs(capsys, monkeypatch):
    """Phase (K) on the CPU with the smoke configs (the host standing in
    for the card): every leaf of gemma2's first pattern repeat and last
    block, and olmoe's routers, drawn again whole in the reference's key
    order, the model's own leaves at both ends from their offsets; a
    draw that differs in one element fails the phase."""
    import pytest
    import torch
    from repro_torch.models import lm
    smoke = _chip_smoke()
    rec = smoke.init_phase(device="cpu", card="cpu", full=False, edge=1000)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == json.loads(json.dumps(rec)) and line["phase"] == "init"
    g, o = line["configs"]
    assert (g["config"], o["config"]) == ("gemma2-smoke", "olmoe-smoke")
    # gemma2-smoke: 2 x 2 blocks of 7 weights; blocks 0, 1 and 3 whole,
    # the tied embed's two ends
    assert g["host_checked"]["leaf_spans"] == 3 * 7 + 2
    # olmoe-smoke: 2 blocks, one router each; embed's and unembed's ends
    assert o["host_checked"]["leaf_spans"] == 2 + 2 * 2
    assert line["ported_kernel_launches"] == {
        k: 0 for k in ("event_matmul2", "window_cumsum", "flash_attn",
                       "event_matmul", "sigma_delta")}

    def off_by_one(cfg, key, device):
        model = init(cfg, key, device)
        with torch.no_grad():
            model.blocks[-1].mlp.wo.view(-1)[5] += 1
        return model
    init = lm.init_params
    monkeypatch.setattr(lm, "init_params", off_by_one)
    with pytest.raises(RuntimeError, match=r"\(K\) gemma2-smoke 3 mlp.wo"):
        smoke.init_phase(device="cpu", card="cpu", full=False, edge=1000)
