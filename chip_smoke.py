#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  (a) build     — compile the CUDA kernels (``src/repro_torch/csrc/*.cu``)
                  with nvcc for sm_90a and load them.
  (b) main_path — a chip-filling Loihi-2 deployment at full width:
                  fc 1024-2048-1024-1024-512, sd_relu (threshold 0.05),
                  weight density 0.5, T = 1024 steps at input density 0.1.
                  Functional run through the event backend's kernel mode
                  (float32 values, int8 counters, value-only base rows: 11
                  ``event_matmul2`` launches per run_batch), single-
                  candidate pricing into a SimReport, a floorline fit over
                  five input densities, and the greedy §VI-B partitioner.
                  Kernel launch counts are zeroed just before and read just
                  after; every kernel must have launched.
  profile       — one more run_batch under torch.profiler: device busy
                  time, the device's idle share, the top kernels.
  (c) kernels   — every kernel against its plain PyTorch version on the
                  card, teacher-forced at the main path's own operands
                  (values in float32 and, joint, in bfloat16; counters as
                  float and as int8 masks; the value-only base rows), on a
                  strided conv stack through im2col, and on edge cases
                  (bm = 64 with a threshold); two launches of each of the
                  six instances (1-D and joint, float32 / bfloat16 / int8)
                  bit for bit, with and without a split k list.
  (d) dense     — the same workload through the dense backend.
  (e) times     — CUDA-event times of each kernel's launch alone (``ms``),
                  of its wrappers (the public one, which lays the weights
                  out per call, and the event backend's on cached
                  weights), of its plain version and of one PyTorch call
                  computing the same function, beside the card's bound for
                  the same work: by the method the kernel uses (3xTF32 at
                  the TF32 rate, int8, bytes) and at the fp32 FMA rate.
                  ``event_matmul2`` is timed at the largest value and
                  counter launches, the narrowest layer, a base-row value
                  launch, the largest delta stream with half its windows
                  quiet (dead activation tiles) and whisper-base's fc2 at
                  M = 448 (448x2048 @ 2048x512, a split k list); the share
                  of live tile products of every main-path launch is
                  printed too.  ``window_cumsum`` at the widest stream.
  (f) frontend  — the model-zoo frontend at full width: whisper-base's full
                  config compiled at its decoder context (seq_len 448; 97
                  fc layers, 0.435 G weight entries) with every attention
                  site verified on the card, then 448 decoded tokens through
                  the event backend's kernel mode.  Launch counts are zeroed
                  before the compile and read after the run; every MAC
                  counter equals 448 * macs_per_token and every counter is
                  bit-identical to a dense run.  One more kernel-mode run
                  is traced as in ``profile``, with the device time of each
                  kernel family.
  (g) pricing   — four compiled smoke archs (gemma2, mamba2, olmoe, whisper)
                  priced on loihi2_like through kernel mode and dense; the
                  per-layer counters equal ``tests/golden/model_*.json``.
  (h) attention — ``attention_probe`` at all 18 lowered sites of full
                  whisper-base (seq_len 448) and all 26 of full gemma2-2b
                  (seq_len 8192), and edge cases (a window that bites,
                  ragged Sq != Skv with masked keys, GQA 10/1, hd 112,
                  B = 2, peaked scores from q x 4 at whisper's encoder
                  shape, hd 36, hd 3, ragged Sq = Skv = 1000): the flash
                  kernel within the frontend's own probe limit
                  (``PROBE_ATOL``, 2e-4) of its plain version.
  (i) times     — ``flash_attn`` at whisper's encoder site, its decoder
                  self-attention site (S 448, causal) and gemma2's global
                  site, as in (e), bound by 3xTF32 and at the fp32 FMA
                  rate, with nvcc's registers and spills per instance.
                  The library call is ``scaled_dot_product_attention`` at
                  whisper's sites and, for gemma2's tanh softcap,
                  ``flex_attention`` compiled by Inductor (its caches under
                  ``build/``), each held to the plain version first.
  (j) kernel_api — the public kernel API (``repro_torch.kernels``, the
                  JAX package's ``repro.kernels``) on the slice-1 cell's own
                  streams: ``sigma_delta_encode`` of fc0's (T, 2048)
                  activations against the state one step behind (theta
                  0.05), then ``event_matmul_pair`` of the messages with
                  fc1's weights and ``event_matmul`` of fc0's operands,
                  both without weight occupancy (the 1-D kernel).  Launch
                  counts are zeroed before and read after: one encoder and
                  three 1-D matmul launches, counters bit-identical.
  (k) kernels   — the 1-D ``event_matmul`` against its plain version: (j)'s
                  value product (fc1, 1024x2048 @ 2048x1024, on the encoded
                  messages), and at fc0 (1024x1024 @ 1024x2048) float32
                  with every tile live, 25% of the tiles live in float32
                  and bfloat16, and whisper-base's fc2 shape at M = 448;
                  the pair on fc0's teacher-forced operands (counters equal
                  to dense and to ``event_matmul2``'s).  The encoder bit for
                  bit against its plain version at fc0's stream and at
                  whisper-base's widest map (1500, 2048), float32 and bf16.
  (l) times     — both kernels as in (e), and each launch alone after a
                  write that evicts the L2 (``time_ms_cold``); the encoder's
                  ``ms`` is that cold time.  The library call is
                  ``torch.matmul`` for the 1-D matmul, none for the encoder.
  (m) population — 1024 (partition, mapping) candidates of the slice-1 cell
                  (the minimal partition and the greedy walk's, each with
                  ordered, strided and random mappings) priced through
                  ``evaluate_population`` with the ``numpy`` and ``device``
                  backends from one pricing cache: device within rtol 1e-9
                  of numpy, 16 spread-out candidates bit-identical to
                  ``simulate``, evaluation counts exact; candidates per
                  second, cache build time, peak device memory.
  (n) guidance  — floorline guidance per layer at the slice-1 cell.
  (o) sparsity_profile — ``tests/golden/trained_profile.npz`` (loaded with
                  the port's ``SparsityProfile``) applied, seed 0, to the
                  slice-1 cell: its 3 activation densities resampled to the
                  4 layers (0.3, 0.4, 0.367, 0.2) as message gates, exact-
                  density weight masks at 0.6 / 0.8 / 0.7 / 0.7 over the
                  existing weights.  A kernel-mode ``run_batch`` of the
                  profiled cell launches ``event_matmul2`` and
                  ``window_cumsum`` as (b) does, with counters bit-identical
                  to dense; live-tile shares and wall times.  Phase (g) also
                  reproduces the three golden fixtures priced under that
                  profile.
  (p) search    — ``greedy_then_evolve`` on the profiled cell (population
                  64, 10 generations, seed 0) through a ``SimEvaluator``
                  with the profile, kernel mode and the ``device``
                  population backend, then again with ``numpy`` on the same
                  cache: no demotion, never worse than the greedy walk, a
                  non-empty front, the best and the knee re-priced by
                  ``simulate`` within rtol 1e-9, every generation's best
                  time within rtol 1e-9 across the backends; candidates per
                  second per backend.
  (q) resume    — each backend's search killed after generation 4
                  (``FaultPlan``, the scripted ``SimulatedCrash``) and
                  resumed from its snapshots under ``build/repro_torch/
                  ckpt/`` (scratch): the result equals the uninterrupted
                  run's, bit for bit where the device pricer gives the same
                  bits twice and in other batches (checked first), else
                  within rtol 1e-9.  Then ``FaultPlan(fail={"device": 2})``:
                  exactly one demotion, device to numpy, and a trajectory
                  within rtol 1e-9 of the numpy-only run.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi reports them, and a last line ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and prints no result.
It exits non-zero without a result when no GPU is visible, or when the
port's package is not beside it.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# HBM3 bandwidth, the float32 rate outside the tensor cores, and the
# tensor-core rates: TF32 (the float32 value products run as 3xTF32:
# three TF32 products per multiply-add), bf16 and int8 (0/1 counter
# products are exact in int8 with int32 sums).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
TILE = 128
DEVICE = "cuda"
THETA = 0.05                          # sigma-delta threshold, phases (j)-(l)
K_POP = 1024                          # candidates priced in phase (m)
PROFILE_PATH = ROOT / "tests" / "golden" / "trained_profile.npz"
SEARCH = dict(population_size=64, generations=10, seed=0)   # phases (p), (q)
KILL_AFTER = 4                        # phase (q)'s scripted crash

# stated tolerances
PRE_RTOL, PRE_ATOL = 1e-5, 1e-5       # kernel vs plain / dense pre-acts
WIN_RTOL, WIN_ATOL = 1e-6, 1e-6       # window_cumsum kernel vs plain
REPORT_RTOL = 1e-3                    # event vs dense time / energy
EM_TOL = {"float32": (1e-6, 1e-5),    # 1-D event_matmul vs plain (rtol,
          "bfloat16": (2e-2, 2e-2)}   # atol); bf16 compared in bf16
POP_RTOL = 1e-9                       # device vs numpy population pricing
SEARCH_RTOL = 1e-9                    # search objectives across backends
REPORT_ARRAYS = ("times", "energies", "per_core_synops", "per_core_acts",
                 "per_core_msgs_out")
REPORT_SCALARS = ("time_per_step", "energy_per_step", "max_synops",
                  "max_acts", "max_link_load")
FIELDS = ("msgs_in", "macs", "fetches_dense", "msgs_out", "acts_evented")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def close(a, b, rtol, atol, what: str) -> float:
    import torch
    err = float((a - b).abs().max()) if a.numel() else 0.0
    require(torch.allclose(a, b, rtol=rtol, atol=atol),
            f"{what}: max abs err {err} beyond rtol={rtol} atol={atol}")
    return err


def exact(a, b, what: str) -> None:
    import torch
    require(torch.equal(a, b), f"{what}: not bit-identical")


def reports_close(got, want, rtol: float) -> float:
    """Hold two lists of SimReports to each other over the fields of the
    JAX package's population parity check (arrays with an atol of rtol,
    scalars as np.isclose, stages, core counts and M0 metrics); returns
    the largest relative difference where the wanted value is nonzero."""
    import numpy as np
    import torch
    worst = 0.0
    for f in REPORT_ARRAYS:
        a = torch.cat([getattr(r, f) for r in got])
        b = torch.cat([getattr(r, f) for r in want])
        require(a.shape == b.shape and torch.allclose(a, b, rtol=rtol,
                                                      atol=rtol),
                f"population {f} beyond rtol {rtol}")
        nz = b != 0
        if bool(nz.any()):
            worst = max(worst, float(((a - b)[nz] / b[nz]).abs().max()))
    for f in REPORT_SCALARS + ("msgs_total", "weight_density",
                               "act_density"):
        src = (lambda r: getattr(r.metrics, f)) if f in (
            "msgs_total", "weight_density", "act_density") else (
            lambda r: getattr(r, f))
        a = np.array([src(r) for r in got])
        b = np.array([src(r) for r in want])
        require(bool(np.isclose(a, b, rtol=rtol).all()),
                f"population {f} beyond rtol {rtol}")
        nz = b != 0
        if nz.any():
            worst = max(worst, float(np.abs((a - b)[nz] / b[nz]).max()))
    for x, y in zip(got, want):
        require((x.bottleneck_stage, x.n_cores_active)
                == (y.bottleneck_stage, y.n_cores_active),
                "population stage or core count")
        for m in ("synops", "acts", "traffic"):
            u, v = getattr(x.metrics, m), getattr(y.metrics, m)
            require((u.n_units, u.n_active) == (v.n_units, v.n_active)
                    and np.allclose([u.total, u.max, u.imbalance],
                                    [v.total, v.max, v.imbalance],
                                    rtol=rtol, atol=0.0),
                    f"population metrics.{m}")
    return worst


def reports_identical(a, b) -> bool:
    import torch
    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in REPORT_ARRAYS)
            and all(getattr(a, f) == getattr(b, f) for f in
                    REPORT_SCALARS + ("bottleneck_stage", "n_cores_active",
                                      "metrics")))


def gpu_name_and_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Median over ``batches`` of the mean time of ``reps`` back-to-back
    calls, timed with CUDA events around each batch (after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def time_ms_cold(fn, reps: int = 20) -> float:
    """Median time of ``reps`` calls, each timed alone with CUDA events
    after a 256 MB write that evicts the 50 MB L2, so the call reads its
    inputs from HBM (the host enqueues the call while the write runs)."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b))
    return statistics.median(per_call)


def flash_ptxas(log: pathlib.Path) -> dict:
    """nvcc's report for each flash_attn instance (its head-dim class HD,
    16- or 4-byte copies): the registers and spill lines that follow its
    entry in build.log."""
    import re
    out, hd = {}, None
    for line in log.read_text().splitlines() if log.exists() else []:
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"flash_attn_kernelILi(\d+)ELb(\d)E",
                          entry.group(1))
            hd = (f"HD {m.group(1)}, {16 if m.group(2) == '1' else 4}-byte "
                  "copies" if m else None)
        elif hd and ("registers" in line or "spill" in line):
            out.setdefault(hd, []).append(line.split(":", 1)[-1].strip())
    return out


#: Kernel families in a trace, by substrings of their kernels' names: the
#: block-sparse matmul is its tile body plus the split-sum pass.
FAMILIES = {"event_matmul": ("event_matmul_kernel", "reduce_splits"),
            "flash_attn": ("flash_attn",),
            "window_cumsum": ("window_cumsum",),
            "sigma_delta": ("sigma_delta",)}


def traced(fn) -> dict:
    """Wall time, device busy time, the device's idle share, the device
    time of each kernel family and the top kernels of one call of ``fn``
    under torch.profiler (ending in a synchronise)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a host op's self device time repeats the
    # time of the kernels it launched
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    by_kernel = sorted(((e.key, dev_us(e), e.count)
                        for e in trace.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and dev_us(e) > 0), key=lambda r: -r[1])
    busy_s = sum(us for _, us, _ in by_kernel) * 1e-6
    families = {f: sum(us for k, us, _ in by_kernel
                       if any(p in k for p in parts)) * 1e-6
                for f, parts in FAMILIES.items()}
    return {"wall_s": wall,
            "device_busy_s": busy_s if busy_s else "not measured",
            "device_idle_share": (1 - busy_s / wall) if busy_s
            else "not measured",
            "family_device_s": families if busy_s else "not measured",
            "top_kernels": [{"name": k[:90], "device_s": us * 1e-6,
                             "calls": n} for k, us, n in by_kernel[:10]]}


def recorder():
    """A kernel-mode event backend that keeps every synaptic forward's
    operands (``.calls``) and every value-only pass's (``.bases``,
    ``.deltas``), for the teacher-forced checks of phases (c) and (o)."""
    from repro_torch.neuromorphic import EventCompute

    class Recorder(EventCompute):
        def __init__(self):
            super().__init__(mode="kernel")
            self.calls, self.deltas, self.bases = [], [], []

        def forward(self, layer, x_eff, act_mask, msgs_in):
            self.calls.append((layer, x_eff, act_mask, msgs_in))
            return super().forward(layer, x_eff, act_mask, msgs_in)

        def value_forward(self, layer, x_eff):
            self.bases.append((layer, x_eff))
            return super().value_forward(layer, x_eff)

        def delta_forward(self, layer, x_in, in_acc, act_mask, msgs_in):
            self.deltas.append((layer, x_in, in_acc.clone()))
            return super().delta_forward(layer, x_in, in_acc, act_mask,
                                         msgs_in)
    return Recorder()


def live_tiles(x, w):
    """(Mb, Nb, Kb) bool live tile products of ``x @ w``, the padded
    ``x``, its tile activity and the weight-tile occupancy, as the
    wrapper computes them."""
    from repro_torch.kernels.event_matmul.ops import (pad_compact,
                                                      weight_block_occupancy)
    xp, active, _, _ = pad_compact(x, 0.0)
    occ = weight_block_occupancy(w)
    return active[:, None, :] & occ.T[None, :, :], xp, active, occ


def search_phases(net, xs, chip, *, ckpt_root, expect_launches: dict,
                  card: str, search: dict = SEARCH) -> None:
    """Phases (o) to (q) on the slice-1 cell ``(net, xs, chip)``: the
    committed trained profile applied to it, the greedy-then-evolutionary
    search over the profiled cell with both population backends, and
    kill-and-resume plus a scripted demotion.  ``expect_launches`` is the
    kernel launches of one ``run_batch`` of the cell (none on the CPU,
    where every wrapper runs its plain version).  Search snapshots go
    under ``ckpt_root`` (scratch, emptied first)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import resilience as R
    from repro_torch.core.partitioner import SimEvaluator
    from repro_torch.core.search import (Population, evolutionary_search,
                                         greedy_then_evolve)
    from repro_torch.kernels.event_matmul.ops import event_matmul2
    from repro_torch.kernels.sigma_delta.ops import window_cumsum
    from repro_torch.neuromorphic import (EventCompute, simulate,
                                          simulate_population)
    from repro_torch.sparsity import SparsityProfile

    counted = {"event_matmul2": event_matmul2, "window_cumsum": window_cumsum}

    def sync():
        if net.device.type == "cuda":
            torch.cuda.synchronize()

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def launches():
        return {k: fn.launches for k, fn in counted.items()}

    # ----------------------------------------- (o) the trained profile
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    profile = SparsityProfile.load(PROFILE_PATH)
    dens = profile.densities_for(len(net.layers))
    pnet = profile.apply(net, seed=0)
    sync()
    apply_s = time.perf_counter() - t0
    require(np.allclose(dens, [0.3, 0.4, 0.55 / 1.5, 0.2], rtol=1e-12,
                        atol=0.0), f"resampled densities {dens}")
    for i, (a, b) in enumerate(zip(net.layers, pnet.layers)):
        keep = int(round(float(dens[i]) * b.n_neurons))
        require(int(b.msg_gate.sum()) == keep, f"{b.name}: gate count")
        wd = float(profile.weight_density[min(i, profile.n_layers - 1)])
        require(int((b.weights != 0).sum())
                <= int(round(wd * b.n_weights)), f"{b.name}: mask count")
        require(bool(((b.weights == 0) | (b.weights == a.weights)).all()),
                f"{b.name}: masked weights are not the original ones")
    rec = recorder()
    zero()
    sync()
    t0 = time.perf_counter()
    run_o = pnet.run_batch(xs, compute=rec)
    sync()
    run_s = time.perf_counter() - t0
    launches_o = launches()
    require(launches_o == expect_launches,
            f"profiled run_batch launches {launches_o} != {expect_launches}")
    t0 = time.perf_counter()
    run_dense = pnet.run_batch(xs, compute="dense")
    sync()
    dense_s = time.perf_counter() - t0
    for layer, a, b in zip(pnet.layers, run_o[1], run_dense[1]):
        for f in FIELDS:
            exact(getattr(a, f), getattr(b, f), f"profiled {layer.name} {f}")
    require(bool(torch.isfinite(run_o[0]).all()), "profiled: non-finite")
    live = [[float(live_tiles(x, layer.weights)[0].float().mean()),
             float(live_tiles(m, layer.w_mask)[0].float().mean())]
            for layer, x, m, _ in rec.calls]
    del rec
    T = xs.shape[0]
    emit({"phase": "sparsity_profile", "source": str(
        PROFILE_PATH.relative_to(ROOT)), "seed": 0,
        "profile_layers": list(profile.layer_names),
        "act_density_programmed": dens.tolist(),
        "weight_density_applied": [
            float(profile.weight_density[min(i, profile.n_layers - 1)])
            for i in range(len(net.layers))],
        "weight_density_after": [l.w_nnz / l.n_weights for l in pnet.layers],
        "message_density_measured": [
            float(c.msgs_out.to(torch.float64).sum()) / (T * l.n_neurons)
            for l, c in zip(pnet.layers, run_o[1])],
        "launches": launches_o, "counters": "bit-identical to dense",
        "live_share_value_counter_per_call": live,
        "load_apply_s": apply_s, "run_batch_s": run_s,
        "dense_run_batch_s": dense_s,
        "phase_wall_s": time.perf_counter() - t_phase})

    # ---------------------------------------------------- (p) the search
    class Timed(SimEvaluator):
        """The evaluator, with the wall time and the candidates of its
        population pricings summed (each call ends in a synchronise)."""

        def __init__(self, *args, **kw):
            self.pricing_s, self.priced = 0.0, 0
            super().__init__(*args, **kw)

        def evaluate_population(self, candidates):
            cands = list(candidates)
            t = time.perf_counter()
            try:
                return super().evaluate_population(cands)
            finally:
                sync()
                self.pricing_s += time.perf_counter() - t
                self.priced += len(cands)

    t_phase = time.perf_counter()
    zero()
    sync()
    t0 = time.perf_counter()
    ev_dev = Timed(net, xs, chip, compute=EventCompute(mode="kernel"),
                   population_backend="device", sparsity_profile=profile)
    sync()
    cache_s = time.perf_counter() - t0
    launches_p = launches()
    require(launches_p == expect_launches,
            f"profiled precompute_pricing launches {launches_p}")
    for a, b in zip(pnet.layers, ev_dev.net.layers):   # (o)'s net, again
        exact(a.weights, b.weights, f"{a.name}: profiled weights")
        exact(a.msg_gate, b.msg_gate, f"{a.name}: profiled gate")
    pnet = ev_dev.net
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt = {b: ckpt_root / f"search_{b}" for b in ("device", "numpy")}
    runs = {}
    for backend, ev in (("device", ev_dev),
                        ("numpy", Timed(pnet, xs, chip, cache=ev_dev.cache))):
        t0 = time.perf_counter()
        greedy, evo = greedy_then_evolve(
            pnet, chip, ev, checkpoint_dir=str(ckpt[backend]),
            checkpoint_keep=search["generations"] + 1, **search)
        sync()
        runs[backend] = dict(greedy=greedy, evo=evo, ev=ev,
                             wall=time.perf_counter() - t0)
        require(ev.demotions == [] and evo.demotions == []
                and ev.active_backend == backend,
                f"{backend} search: demotions {ev.demotions}, active "
                f"backend {ev.active_backend}")
        require(evo.report.time_per_step <= greedy.report.time_per_step,
                f"{backend} search worse than the greedy walk")
        require(len(evo.front) > 0, f"{backend} search: empty front")
        for what, (cand, rep) in (("best", (evo.candidate, evo.report)),
                                  ("knee", evo.knee())):
            again = simulate(pnet, xs, chip, cand.partition(),
                             cand.mapping(), precomputed=run_o)
            require(bool(np.isclose(rep.time_per_step, again.time_per_step,
                                    rtol=SEARCH_RTOL, atol=0.0)
                         and np.isclose(rep.energy_per_step,
                                        again.energy_per_step,
                                        rtol=SEARCH_RTOL, atol=0.0)),
                    f"{backend} {what}: search report vs simulate")
    h_dev, h_np = runs["device"]["evo"].history, runs["numpy"]["evo"].history
    require(len(h_dev) == len(h_np), "history lengths")
    best_rel = [abs(a.best_time - b.best_time) / b.best_time
                for a, b in zip(h_dev, h_np)]
    require(max(best_rel) <= SEARCH_RTOL,
            f"per-generation best_time device vs numpy {best_rel}")
    snaps = {b: R.SearchCheckpointer(str(d)) for b, d in ckpt.items()}
    same_genomes = 0
    for g in range(len(h_np)):
        a, _, _ = snaps["device"].restore(g)
        b, _, _ = snaps["numpy"].restore(g)
        same_genomes += int(np.array_equal(a["cores"], b["cores"])
                            and np.array_equal(a["perm"], b["perm"]))
    emit({"phase": "search", "cell": "slice-1, trained profile (seed 0)",
          "card": card,
          "search": search, "cache_build_s": cache_s,
          "profiled_precompute_pricing_launches": launches_p,
          "greedy": {"iters": len(runs["numpy"]["greedy"].history),
                     "time_per_step":
                         runs["numpy"]["greedy"].report.time_per_step,
                     "partition": list(
                         runs["numpy"]["greedy"].partition.cores)},
          "best": {b: {"time_per_step": r["evo"].report.time_per_step,
                       "energy_per_step": r["evo"].report.energy_per_step,
                       "partition": list(r["evo"].partition.cores),
                       "front": len(r["evo"].front),
                       "seed_best_time": r["evo"].seed_best_time}
                   for b, r in runs.items()},
          "best_time_per_generation": {"device": [h.best_time
                                                  for h in h_dev],
                                       "numpy": [h.best_time for h in h_np]},
          "max_rel_diff_best_time": max(best_rel), "rtol": SEARCH_RTOL,
          "generations_with_identical_genomes": [same_genomes, len(h_np)],
          "n_evals": {b: r["evo"].n_evals for b, r in runs.items()},
          "evaluator_n_evals": {b: r["ev"].n_evals for b, r in runs.items()},
          "wall_s": {b: r["wall"] for b, r in runs.items()},
          "pricing_s": {b: r["ev"].pricing_s for b, r in runs.items()},
          "candidates_per_s": {b: r["ev"].priced / r["ev"].pricing_s
                               for b, r in runs.items()},
          "demotions": "none (both backends)",
          "phase_wall_s": time.perf_counter() - t_phase})

    # ---------------------------------------- (q) resume and demotion
    t_phase = time.perf_counter()
    # does the device pricer give the same bits twice, and in another
    # batch?  (its sums use scatter_add_, index_add_ and scatter_reduce)
    last, _, _ = snaps["device"].restore()
    pop = Population(last["cores"], last["perm"])
    pairs = pop.pairs()
    price = lambda ps: simulate_population(pnet, xs, chip, ps,
                                           cache=ev_dev.cache,
                                           backend="device")
    first, second = price(pairs), price(pairs)
    # the same rows in reverse order, and the first 7 alone (a resume
    # re-prices survivors and the front in batches of their own)
    other = price(pairs[::-1])[::-1] + price(pairs[:7])
    fields = REPORT_ARRAYS + REPORT_SCALARS + ("bottleneck_stage",)

    def differing(xs_, ys_):
        out = set()
        for x, y in zip(xs_, ys_):
            for f in fields:
                u, v = getattr(x, f), getattr(y, f)
                if not (torch.equal(u, v) if isinstance(u, torch.Tensor)
                        else u == v):
                    out.add(f)
        return sorted(out)
    diff_twice = differing(first, second)
    diff_batch = differing(first + first[:7], other)
    deterministic = not diff_twice and not diff_batch
    resumed = {}
    for backend in ("numpy", "device"):
        d = ckpt_root / f"resume_{backend}"
        greedy = runs[backend]["greedy"]
        crashed = False
        try:
            evolutionary_search(
                pnet, chip, SimEvaluator(pnet, xs, chip, cache=ev_dev.cache,
                                         population_backend=backend,
                                         fallback=False),
                greedy=greedy, checkpoint_dir=str(d),
                fault_plan=R.FaultPlan(kill_after_gen=KILL_AFTER), **search)
        except R.SimulatedCrash:          # the scripted kill under test
            crashed = True
        require(crashed, f"{backend}: the scripted kill did not fire")
        require(R.SearchCheckpointer(str(d)).latest() == KILL_AFTER,
                f"{backend}: newest snapshot after the kill")
        t0 = time.perf_counter()
        res = evolutionary_search(
            pnet, chip, SimEvaluator(pnet, xs, chip, cache=ev_dev.cache,
                                     population_backend=backend,
                                     fallback=False),
            greedy=greedy, checkpoint_dir=str(d), resume=True, **search)
        sync()
        resume_s = time.perf_counter() - t0
        full = runs[backend]["evo"]
        bits = backend == "numpy" or deterministic
        a, _, _ = R.SearchCheckpointer(str(d)).restore()
        b, _, _ = snaps[backend].restore()
        for k in sorted(b):
            if b[k].dtype.kind != "f":
                require(np.array_equal(a[k], b[k]),
                        f"{backend} resume: final snapshot {k}")
        objs = lambda h: np.array([[g.best_time, g.best_energy, g.mean_time]
                                   for g in h])
        ft = lambda r: np.array([[x.time_per_step, x.energy_per_step]
                                 for x in r.front_reports])
        # final population and archive objectives, the history's, the
        # front reports'
        floats = [(a[k], b[k]) for k in sorted(b) if b[k].dtype.kind == "f"]
        floats += [(objs(res.history), objs(full.history)),
                   (ft(res), ft(full))]
        same_bits = all(x.shape == y.shape and np.array_equal(x, y)
                        for x, y in floats)
        require(same_bits or not bits, f"{backend} resume: not bit for bit")
        require(all(np.allclose(x, y, rtol=SEARCH_RTOL, atol=0.0)
                    for x, y in floats),
                f"{backend} resume: objectives beyond rtol {SEARCH_RTOL}")
        worst = max(float(np.max(np.abs(x - y)[y != 0] / np.abs(y[y != 0]),
                                 initial=0.0)) for x, y in floats)
        hist = lambda h: [(g.generation, g.n_evals, g.front_size,
                           g.n_quarantined) for g in h]
        require(hist(res.history) == hist(full.history),
                f"{backend} resume: history counts")
        genomes = lambda cs: [(c.cores, c.perm) for c in cs]
        require(genomes(res.front) == genomes(full.front)
                and genomes([res.candidate, res.knee()[0]])
                == genomes([full.candidate, full.knee()[0]]),
                f"{backend} resume: best, front or knee genomes")
        resumed[backend] = {"killed_after_generation": KILL_AFTER,
                            "held_to": "bit-identical" if bits
                            else f"rtol {SEARCH_RTOL}",
                            "bit_identical": same_bits,
                            "max_rel_diff": worst, "resume_s": resume_s}
    ev_f = SimEvaluator(pnet, xs, chip, cache=ev_dev.cache,
                        population_backend="device")
    res_f = evolutionary_search(pnet, chip, ev_f,
                                greedy=runs["device"]["greedy"],
                                fault_plan=R.FaultPlan(fail={"device": 2}),
                                **search)
    dem = ev_f.demotions
    require(len(dem) == 1 and (dem[0].frm, dem[0].to) == ("device", "numpy")
            and res_f.demotions == dem and ev_f.active_backend == "numpy",
            f"scripted demotion: {dem}")
    f_rel = [abs(a.best_time - b.best_time) / b.best_time
             for a, b in zip(res_f.history, h_np)]
    require(len(res_f.history) == len(h_np) and max(f_rel) <= SEARCH_RTOL,
            f"demoted run vs numpy-only run {f_rel}")
    emit({"phase": "resume", "device_pricer_deterministic": deterministic,
          "fields_differing_when_priced_twice": diff_twice,
          "fields_differing_in_another_batch": diff_batch,
          "population_checked": len(pairs), "resume": resumed,
          "scripted_demotion": {"fault_plan": "fail={'device': 2}",
                                "retry": "RetryPolicy() (one retry)",
                                "demotions": [dataclasses.asdict(x)
                                              for x in dem],
                                "max_rel_diff_best_time_vs_numpy":
                                    max(f_rel)},
          "checkpoints": str(ckpt_root),
          "phase_wall_s": time.perf_counter() - t_phase})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 2
    # Inductor and Triton (phase i's flex_attention) cache inside build/
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(build.BUILD_DIR / sub))
    import repro_torch.kernels as kernels_api
    from repro_torch.core.floorline import WorkloadPoint, fit_floorline
    from repro_torch.core.guidance import floorline_layer_guidance
    from repro_torch.core.partitioner import (SimEvaluator,
                                              optimize_partitioning)
    from repro_torch.kernels.event_matmul.ops import (
        KernelWeights, _compact_indices_joint, _pad_to, block_activity,
        event_matmul, event_matmul2, event_matmul_packed, event_matmul_pair,
        pad_compact, weight_block_occupancy)
    from repro_torch.kernels.event_matmul.ops import (
        bind_launch as em_bind_launch)
    from repro_torch.kernels.event_matmul.ref import (event_matmul2_ref,
                                                      event_matmul_ref)
    from repro_torch.kernels.flash_attn.ops import (bind_launch,
                                                    flash_attention)
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.kernels.sigma_delta.ops import (sigma_delta_encode,
                                                     window_cumsum,
                                                     window_reconstruct)
    from repro_torch.kernels.sigma_delta.ref import (sigma_delta_ref,
                                                     window_cumsum_ref,
                                                     window_reconstruct_ref)
    from repro_torch.configs import registry
    from repro_torch.neuromorphic import (DenseCompute, EventCompute,
                                          attention_probe, compile_network,
                                          excluded_params, fc_network,
                                          loihi2_like, lowering_spec,
                                          make_inputs, minimal_partition,
                                          network_from_numpy,
                                          ordered_mapping,
                                          precompute_pricing,
                                          random_mapping, simulate,
                                          strided_mapping)
    from repro_torch.neuromorphic.compute import _im2col, _patch_weights
    from repro_torch.neuromorphic.frontend import PROBE_ATOL
    from repro_torch.sparsity import SparsityProfile
    import numpy as np
    import torch.nn.functional as F
    # the recipes of the golden fixtures, shared with the tests
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_workloads import conv_specs

    dev = torch.device(DEVICE)
    card = gpu_name_and_limit()

    # ------------------------------------------------------------ (a) build
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    log = (build.BUILD_DIR / "build.log")
    ptxas = ([l.strip() for l in log.read_text().splitlines()
              if "registers" in l or "spill" in l] if log.exists() else [])
    emit({"phase": "build", "seconds": build_s,
          "library": build.library_path().name, "ptxas": ptxas,
          "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -------------------------------------------------------- (b) main path
    sizes = [1024, 2048, 1024, 1024, 512]
    T = 1024
    net = fc_network(sizes, weight_density=0.5, neuron_model="sd_relu",
                     seed=0, device=DEVICE)
    for layer in net.layers:
        layer.threshold = 0.05
    xs = make_inputs(sizes[0], density=0.1, steps=T, seed=1,
                     device=DEVICE)
    prof = loihi2_like()
    part = minimal_partition(net, prof)
    n_delta = len(net.layers) - 1          # every layer after an sd_relu one
    # a value and a counter launch per layer, one value-only launch for
    # each delta layer's base rows
    expect = {"event_matmul2": 2 * len(net.layers) + n_delta,
              "window_cumsum": n_delta}
    counters = {"event_matmul2": event_matmul2,
                "window_cumsum": window_cumsum}
    rec = recorder()
    walls = {}

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_k = net.run_batch(xs, compute=rec)
    torch.cuda.synchronize()
    walls["run_batch"] = time.perf_counter() - t0
    per_run = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    rep = simulate(net, xs, prof, part, precomputed=run_k)
    walls["simulate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pts = []
    for dens in (0.8, 0.5, 0.3, 0.1, 0.05):
        xs_d = make_inputs(sizes[0], dens, T, seed=2, device=DEVICE)
        r = simulate(net, xs_d, prof, compute=EventCompute(mode="kernel"))
        pts.append(WorkloadPoint(r.max_synops, r.max_acts, r.time_per_step,
                                 r.energy_per_step, label=f"d={dens}"))
    model = fit_floorline(pts)
    state = model.classify(WorkloadPoint(rep.max_synops, rep.max_acts,
                                         rep.time_per_step))
    walls["floorline"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluator = SimEvaluator(net, xs, prof, compute="event")
    res = optimize_partitioning(net, prof, evaluator, max_iters=8)
    torch.cuda.synchronize()
    walls["greedy"] = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}

    outputs = run_k[0]
    require(tuple(outputs.shape) == (T, sizes[-1]), "output shape")
    require(bool(torch.isfinite(outputs).all()), "non-finite outputs")
    require(np.isfinite(rep.time_per_step) and rep.time_per_step > 0,
            "time_per_step")
    require(np.isfinite(rep.energy_per_step) and rep.energy_per_step > 0,
            "energy_per_step")
    require(per_run == expect, f"launches per run_batch {per_run} != "
                               f"{expect}")
    require(all(n > 0 for n in launches.values()), f"launches {launches}")
    speedup = res.history[0].time / res.report.time_per_step
    emit({"phase": "main_path", "sizes": sizes, "T": T,
          "partition": list(part.cores), "cores_used": part.total_cores,
          "time_per_step": rep.time_per_step,
          "energy_per_step": rep.energy_per_step,
          "bottleneck_stage": rep.bottleneck_stage,
          "floorline_state": state.value,
          "greedy_speedup": speedup, "greedy_iters": len(res.history),
          "greedy_partition": list(res.partition.cores),
          "greedy_evals": evaluator.n_evals,
          "launches_per_run_batch": per_run, "launches": launches,
          "wall_s": walls})

    # ------------------------- where one run_batch's time goes (profiler)
    emit({"phase": "profile", "what": "one run_batch, kernel mode, traced",
          **traced(lambda: net.run_batch(
              xs, compute=EventCompute(mode="kernel")))})

    # ------------------------------------------- (c) kernels vs plain, card
    t0 = time.perf_counter()
    kernel_cc, dense_cc = EventCompute(mode="kernel"), DenseCompute()
    max_err = {"event_matmul2": 0.0, "window_cumsum": 0.0}
    checks = 0

    def check_matmul(x, w, occ, what, mask_operand=False):
        """The joint kernel against its plain version: masks exactly, as
        float32 (the float32 instance) and as int8 (the int8 one)."""
        nonlocal checks
        M, N = x.shape[0], w.shape[1]
        ops = [(x, w)] + ([(x.to(torch.int8), w.to(torch.int8))]
                          if mask_operand else [])
        for xo, wo in ops:
            y = event_matmul2(xo, wo, occ)
            y_ref = event_matmul2_ref(_pad_to(xo, (TILE, TILE)),
                                      _pad_to(wo, (TILE, TILE)), occ,
                                      threshold=0.0, bm=TILE, bk=TILE,
                                      bn=TILE)[:M, :N]
            require(y.dtype == torch.float32, f"{what}: type {y.dtype}")
            if mask_operand:
                exact(y, y_ref, f"{what} ({xo.dtype})")
            else:
                max_err["event_matmul2"] = max(
                    max_err["event_matmul2"],
                    close(y, y_ref, PRE_RTOL, PRE_ATOL, what))
            checks += 1
        return y

    def check_forward(layer, x, m, msgs, what):
        nonlocal checks
        pre_k, macs_k, fetch_k = kernel_cc.forward(layer, x, m, msgs)
        pre_d, macs_d, fetch_d = dense_cc.forward(layer, x, m, msgs)
        exact(macs_k, macs_d, f"{what} macs")
        exact(fetch_k, fetch_d, f"{what} fetches_dense")
        close(pre_k, pre_d, PRE_RTOL, PRE_ATOL, f"{what} pre")
        checks += 1
        return pre_d

    # teacher-forced at the main path's operands
    for i, (layer, x, m, msgs) in enumerate(rec.calls):
        check_forward(layer, x, m, msgs, f"fc call {i} ({layer.name})")
        occ = weight_block_occupancy(layer.weights)
        check_matmul(x, layer.weights, occ, f"fc call {i} values")
        check_matmul(m, layer.w_mask, occ, f"fc call {i} counters",
                     mask_operand=True)
    for layer, xb in rec.bases:            # the value-only base rows
        close(kernel_cc.value_forward(layer, xb), xb @ layer.weights,
              PRE_RTOL, PRE_ATOL, f"{layer.name} base rows")
        checks += 1
    # the joint product in bfloat16, on fc0's operands
    fc0_layer, fc0_x, _, _ = next(c for c in rec.calls
                                  if c[0] is net.layers[0]
                                  and c[1].shape[0] == T)
    fc0_w = fc0_layer.weights
    fc0_occ = weight_block_occupancy(fc0_w)
    xb, wb = fc0_x.to(torch.bfloat16), fc0_w.to(torch.bfloat16)
    yb = event_matmul2(xb, wb, fc0_occ)
    require(yb.dtype == torch.bfloat16, f"bf16 joint: type {yb.dtype}")
    bf16_err = close(yb.float(), event_matmul2_ref(
        xb, wb, fc0_occ, threshold=0.0, bm=TILE, bk=TILE, bn=TILE,
        out_dtype=torch.bfloat16).float(), *EM_TOL["bfloat16"],
        "fc0 joint bfloat16")
    checks += 1
    for layer, x_in, acc in rec.deltas:
        bases, xwin, new_acc = window_reconstruct(x_in, acc, window=TILE)
        rb, rx, ra = window_reconstruct_ref(x_in, acc, window=TILE)
        exact(bases, rb, f"{layer.name} bases")
        exact(new_acc, ra, f"{layer.name} new_acc")
        max_err["window_cumsum"] = max(max_err["window_cumsum"], close(
            xwin, rx, WIN_RTOL, WIN_ATOL, f"{layer.name} window_cumsum"))
        checks += 1

    # a strided conv stack through im2col: 3x3 stride-2 convs on a 64x64x2
    # input, channels 16 / 32 / 64, T = 32
    rng = np.random.default_rng(7)
    specs, h, c_prev = [], 64, 2
    for i, c in enumerate((16, 32, 64)):
        wgt = rng.normal(0, 1 / np.sqrt(9 * c_prev),
                         (3, 3, c_prev, c)).astype(np.float32)
        wgt *= (rng.random(wgt.shape) < 0.6)
        specs.append(dict(name=f"conv{i}", kind="conv", weights=wgt,
                          stride=2, in_hw=(h, h)))
        h, c_prev = h // 2, c
    conv_net = network_from_numpy(specs, 64 * 64 * 2, device=DEVICE)
    cur = make_inputs(64 * 64 * 2, 0.3, 32, seed=8, device=DEVICE)
    for layer in conv_net.layers:
        m = (cur != 0).to(torch.float32)
        pre = check_forward(layer, cur, m, m.sum(dim=1), layer.name)
        kh, kw = layer.weights.shape[:2]
        oh, ow = layer.out_hw
        x4 = cur.reshape(32, layer.weights.shape[2], *layer.in_hw)
        wf, wfm, _ = _patch_weights(layer)
        occ = weight_block_occupancy(wf)
        pat = _im2col(x4, kh, kw, layer.stride, oh, ow)
        check_matmul(pat, wf, occ, f"{layer.name} im2col values")
        check_matmul((pat != 0).to(torch.float32), wfm, occ,
                     f"{layer.name} im2col counters", mask_operand=True)
        cur, _ = layer._neuron_batch(pre, {})

    # edge cases: ragged M/K/N, all-zero activation and weight tiles, (m, n)
    # pairs with cnt == 0, a quiet window and ragged T
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(300, 333, generator=g).to(dev)
    w = torch.randn(333, 270, generator=g).to(dev)
    x[:128] = 0.0                          # first m-block: cnt == 0
    x[128:256, 128:256] = 0.0              # one dead activation tile
    w[256:, :] = 0.0                       # last k-block of weights dead
    w[:, 128:256] = 0.0                    # a whole n-block dead: cnt == 0
    occ = weight_block_occupancy(w)
    _, active, _, _ = pad_compact(x, 0.0)
    _, cnt = _compact_indices_joint(active, occ)
    require(int((cnt == 0).sum()) >= 3, "edge case lost its cnt == 0 pairs")
    y = check_matmul(x, w, occ, "edge ragged values")
    require(bool((y[:128] == 0).all()) and bool((y[:, 128:256] == 0).all()),
            "cnt == 0 tiles are not exact zeros")
    check_matmul((x != 0).to(torch.float32), (w != 0).to(torch.float32),
                 occ, "edge ragged counters", mask_operand=True)
    zocc = torch.zeros_like(occ)
    require(bool((event_matmul2(x, w, zocc) == 0).all()),
            "all-unoccupied weights must give exact zeros")
    xd = torch.randn(300, 200, generator=g).to(dev)
    xd[128:256] = 0.0                      # a quiet window in the middle
    for T_edge in (300, 256):
        xe = xd[:T_edge]
        acc = torch.randn(200, generator=g).to(dev)
        bases, xwin, new_acc = window_reconstruct(xe, acc, window=TILE)
        rb, rx, ra = window_reconstruct_ref(xe, acc, window=TILE)
        require(bool((xwin[128:256] == 0).all()),
                "quiet window is not exact zeros")
        max_err["window_cumsum"] = max(max_err["window_cumsum"], close(
            xwin, rx, WIN_RTOL, WIN_ATOL, f"ragged T={T_edge} window"))
        exact(bases, rb, "ragged bases")
        checks += 1
    # tiles other than the kernel's 128 (bm = 64): the dead tiles of x
    # are zeroed, then the 128-tile product runs at threshold 0.  Rows
    # 64-127 of the first m-block hold only sub-threshold entries.
    x64 = fc0_x.clone()
    x64[64:128] = (0.01 * torch.randn((64, x64.shape[1]), generator=g)
                   ).clamp(-0.04, 0.04).to(dev)
    bm64 = {}
    for what, fn in (("1-D", lambda: event_matmul(
            x64, fc0_w, threshold=THETA, bm=64, bk=TILE)),
                     ("joint", lambda: event_matmul2(
            x64, fc0_w, torch.ones_like(fc0_occ), threshold=THETA, bm=64,
            bk=TILE, bn=TILE))):
        y64 = fn()
        y64_ref = event_matmul_ref(x64, fc0_w, threshold=THETA, bm=64,
                                   bk=TILE)
        require(bool((y64[64:128] == 0).all()),
                "bm = 64: a dead tile is not exact zeros")
        bm64[what] = close(y64, y64_ref, *EM_TOL["float32"],
                           f"bm = 64 {what}")
        checks += 1
    # two launches of each instance, bit for bit: fc0's operands (one
    # block per output tile) and whisper-base's fc2 at M = 448 (a split
    # k list)
    xw = torch.relu(torch.randn((448, 2048), generator=g)).to(dev)
    ww = (torch.randn((2048, 512), generator=g) / 2048 ** 0.5).to(dev)
    repeats = {}
    for shape, (xs_, ws_) in (("fc0", (fc0_x, fc0_w)),
                              ("whisper fc2, M 448", (xw, ww))):
        occ_ = weight_block_occupancy(ws_)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            xo, wo = ((xs_ != 0).to(dt), (ws_ != 0).to(dt)) \
                if dt == torch.int8 else (xs_.to(dt), ws_.to(dt))
            for kind, o in (("1-D", None), ("joint", occ_)):
                launch, out = em_bind_launch(xo, KernelWeights(wo, o))
                build.check(launch(), f"{shape} {kind} {dt}")
                first = out.clone()
                build.check(launch(), f"{shape} {kind} {dt}")
                torch.cuda.synchronize()
                exact(out, first, f"{shape} {kind} {dt}: two launches")
                repeats[f"{shape} {kind} {str(dt)[6:]}"] = launch.splits
                checks += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "checks": checks, "max_abs_err": max_err,
          "bf16_joint_max_abs_err": bf16_err, "bm64_max_abs_err": bm64,
          "repeat_launches_bit_identical": repeats,
          "tolerances": {"pre": [PRE_RTOL, PRE_ATOL],
                         "window_cumsum": [WIN_RTOL, WIN_ATOL],
                         "bfloat16": list(EM_TOL["bfloat16"]),
                         "bm64": list(EM_TOL["float32"]),
                         "counters": "bit-identical"},
          "wall_s": time.perf_counter() - t0})

    # ---------------------------------------- (d) end to end against dense
    t0 = time.perf_counter()
    run_d = net.run_batch(xs, compute="dense")
    rep_d = simulate(net, xs, prof, part, precomputed=run_d)
    rel_t = abs(rep.time_per_step - rep_d.time_per_step) / rep_d.time_per_step
    rel_e = (abs(rep.energy_per_step - rep_d.energy_per_step)
             / rep_d.energy_per_step)
    msgs_diff = [int((a.msgs_out != b.msgs_out).sum())
                 for a, b in zip(run_k[1], run_d[1])]
    emit({"phase": "dense", "time_per_step": rep_d.time_per_step,
          "energy_per_step": rep_d.energy_per_step,
          "rel_diff_time": rel_t, "rel_diff_energy": rel_e,
          "msgs_out_differing_per_layer": msgs_diff,
          "msgs_out_total_per_layer":
              [int(c.msgs_out.sum()) for c in run_d[1]],
          "wall_s": time.perf_counter() - t0})
    require(rel_t <= REPORT_RTOL and rel_e <= REPORT_RTOL,
            f"event vs dense report differs: time {rel_t}, energy {rel_e}")

    # ----------------------------------------------------------- (e) times
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def matmul_bound(M: int, N: int, live, elt: int, out_elt: int,
                     rate: float, products: int) -> dict:
        """Bytes and operations of one block-sparse product, from this
        call's live (Mb, Nb, Kb) tile products: every operand tile some
        live product needs read once (``elt`` bytes an element), the
        activity and occupancy bytes, the (M, N) output written once
        (``out_elt`` bytes), and ``products`` multiply-adds per live MAC at
        ``rate`` (3 at the TF32 rate for 3xTF32).  Also the bound at the
        fp32 FMA rate (one multiply-add per MAC)."""
        mb, nb, kb = live.shape
        macs = TILE ** 3 * int(live.sum())
        nbytes = elt * TILE * TILE * (int(live.any(dim=1).sum())
                                      + int(live.any(dim=0).sum()))
        nbytes += out_elt * M * N + mb * kb + kb * nb
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 2 * products * macs / rate
        return {"bytes": nbytes, "ops": 2 * products * macs,
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "fp32_fma_bound_ms": 1e3 * max(
                    t_bytes, 2 * macs / PEAK_FP32_FLOPS)}

    def time_matmul(x, w, counter: bool, what: str, name: str) -> dict:
        """Launch-alone, wrapper, plain and library times of one
        event_matmul2 call, with its bounds from this call's live tiles.
        Values are float32 (3xTF32), counters int8 0/1 masks (int8 rate,
        float32 out); the library call is ``torch.matmul`` for values and
        ``torch._int_mm`` for counters (``torch.matmul`` of the float
        masks beside it)."""
        live, xp, active, occ = live_tiles(x, w)
        wp = _pad_to(w, (TILE, TILE))
        if counter:
            x, w = (x != 0).to(torch.int8), (w != 0).to(torch.int8)
        kw = KernelWeights(w, occ)
        launch, _ = em_bind_launch(x, kw)
        M, N = x.shape[0], w.shape[1]
        row = {"what": what, "layer": name, "M": M, "K": x.shape[1],
               "N": N, "dtype": str(x.dtype)[6:],
               "live_tile_products": int(live.sum()),
               "tile_products": live.numel(), "splits": launch.splits,
               **matmul_bound(M, N, live, x.element_size(), 4,
                              PEAK_INT8_OPS if counter else PEAK_TF32_FLOPS,
                              1 if counter else 3),
               "method": "int8" if counter else "3xTF32",
               "ms": time_ms(launch),
               "wrapper_ms": time_ms(lambda: event_matmul2(x, w, occ)),
               "packed_wrapper_ms": time_ms(
                   lambda: event_matmul_packed(x, kw)),
               "plain_ms": time_ms(lambda: event_matmul2_ref(
                   _pad_to(x, (TILE, TILE)), _pad_to(w, (TILE, TILE)), occ,
                   threshold=0.0, bm=TILE, bk=TILE, bn=TILE))}
        if counter and M > 16:
            x8, w8 = _pad_to(x, (TILE, TILE)), _pad_to(w, (TILE, TILE))
            row["library_ms"] = time_ms(lambda: torch._int_mm(x8, w8))
            row["library_call"] = "torch._int_mm"
            xf, wf = xp != 0, wp != 0
            xf, wf = xf.to(torch.float32), wf.to(torch.float32)
            row["matmul_f32_ms"] = time_ms(lambda: torch.matmul(xf, wf))
        else:
            row["library_ms"] = time_ms(lambda: torch.matmul(xp, wp))
            row["library_call"] = "torch.matmul"
        return row

    # every main-path launch: (value, counter) live share per forward call
    live_share = []
    for layer, x, m, _ in rec.calls:
        live_share.append([float(live_tiles(a, b)[0].float().mean())
                           for a, b in ((x, layer.weights),
                                        (m, layer.w_mask))])
    mm_rows = []
    layer, x, m, _ = max(rec.calls, key=lambda c: c[1].numel()
                         * c[0].weights.shape[1])
    mm_rows.append(time_matmul(x, layer.weights, False, "largest value",
                               layer.name))
    mm_rows.append(time_matmul(m, layer.w_mask, True, "largest counter",
                               layer.name))
    layer, x, _, _ = min(rec.calls, key=lambda c: (c[0].weights.shape[1],
                                                   -c[1].shape[0]))
    mm_rows.append(time_matmul(x, layer.weights, False, "narrowest layer",
                               layer.name))
    layer, xb = rec.bases[0]
    mm_rows.append(time_matmul(xb, layer.weights, False,
                               "base-row value launch", layer.name))
    widest = max(rec.deltas, key=lambda d: d[1].numel())[0]
    layer, x, _, _ = next(c for c in rec.calls
                          if c[0] is widest and c[1].shape[0] == T)
    xq = x.clone().reshape(T // TILE, TILE, -1)
    xq[1::2] = 0.0                         # windows 1, 3, 5, 7 quiet
    mm_rows.append(time_matmul(xq.reshape(T, -1), layer.weights, False,
                               "widest xwin, half its windows quiet",
                               layer.name))
    mm_rows.append(time_matmul(xw, ww, False, "whisper-base fc2 shape, "
                               "M = 448 (random operands, seed 11)",
                               "whisper fc2"))
    mm = {"name": "event_matmul2", "route": "cuda",
          "source": "src/repro_torch/csrc/event_matmul.cu",
          "replaces": "src/repro/kernels/event_matmul/kernel.py:52",
          "launches": launches["event_matmul2"],
          "max_abs_err": max_err["event_matmul2"]}
    mm.update({k: mm_rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "fp32_fma_bound_ms", "method")})

    # window_cumsum at the main path's widest delta stream
    layer, x_in, _ = max(rec.deltas, key=lambda d: d[1].numel())
    x_in = x_in.contiguous()
    Tp, D = x_in.shape
    xw = x_in.reshape(Tp // TILE, TILE, D)
    lv = (xw != 0).any(dim=2).any(dim=1).to(torch.int32)
    n_lw = int(lv.sum())
    bytes_wc = 4 * (n_lw * TILE * D + Tp * D) + 4 * lv.numel()
    ops_wc = n_lw * TILE * D
    out_wc = torch.empty_like(x_in)
    t_bytes, t_ops = bytes_wc / PEAK_BYTES_PER_S, ops_wc / PEAK_FP32_FLOPS
    wc = {"name": "window_cumsum", "route": "cuda",
          "source": "src/repro_torch/csrc/window_cumsum.cu",
          "replaces": "src/repro/kernels/sigma_delta/kernel.py:37",
          "launches": launches["window_cumsum"],
          "max_abs_err": max_err["window_cumsum"],
          "ms": time_ms(lambda: lib.window_cumsum_launch(
              x_in.data_ptr(), lv.data_ptr(), out_wc.data_ptr(),
              Tp // TILE, D, TILE, stream)),
          "plain_ms": time_ms(lambda: window_cumsum_ref(x_in, lv,
                                                        window=TILE)),
          "bound_ms": 1e3 * max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes > t_ops else "operations",
          "library_ms": time_ms(lambda: torch.cumsum(xw, dim=1))}
    shape_wc = {"T": Tp, "D": D, "window": TILE, "live_windows": n_lw,
                "windows": lv.numel(), "bytes": bytes_wc, "adds": ops_wc,
                "wrapper_ms": time_ms(lambda: window_cumsum(x_in, lv,
                                                            window=TILE)),
                "layer": layer.name}
    emit({"phase": "times", "card": card,
          "peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                    "fp32_flops_per_s": PEAK_FP32_FLOPS,
                    "tf32_flops_per_s": PEAK_TF32_FLOPS,
                    "int8_ops_per_s": PEAK_INT8_OPS,
                    "source": "NVIDIA H100 SXM data sheet"},
          "event_matmul2": mm_rows,
          "event_matmul2_live_share_per_call": live_share,
          "window_cumsum": shape_wc})

    # ---------------------------------------- (f) frontend at full width
    # fc0's teacher-forced operands and fc1's input delta stream, for the
    # public kernel API phases (j)-(l)
    fc0_call = next(c for c in rec.calls
                    if c[0] is net.layers[0] and c[1].shape[0] == T)
    fc1_delta = next(d for d in rec.deltas if d[0] is net.layers[1])
    del rec, run_k, run_d
    torch.cuda.empty_cache()
    kernels = {"event_matmul2": event_matmul2, "window_cumsum": window_cumsum,
               "flash_attn": flash_attention}
    T_W = 448                               # whisper's n_text_ctx
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    cn = compile_network("whisper-base", smoke=False, seq_len=T_W, seed=0,
                         device=DEVICE, verify_attention=True)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    cfg = cn.cfg
    require(cn.param_layer_nnz() + excluded_params(cfg) == cfg.param_count(),
            "whisper-base: param identity")
    xs_w = cn.inputs(T_W, seed=5)
    rec_w = recorder()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_w, cnt_w = cn.net.run_batch(xs_w, compute=rec_w)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches_f = {k: fn.launches for k, fn in kernels.items()}
    n_fc = len(cn.net.layers)
    expect_f = {"event_matmul2": 2 * n_fc, "window_cumsum": 0,
                "flash_attn": len(cn.attn_specs)}
    require(n_fc == 97 and len(cn.attn_specs) == 18,
            f"whisper-base lowered to {n_fc} layers, "
            f"{len(cn.attn_specs)} attention sites")
    require(launches_f == expect_f,
            f"frontend launches {launches_f} != {expect_f}")
    require(tuple(out_w.shape) == (T_W, cfg.vocab_size), "frontend shape")
    require(bool(torch.isfinite(out_w).all()), "frontend: non-finite")
    for spec, c in zip(cn.specs, cnt_w):
        require(int(c.macs.to(torch.float64).sum())
                == T_W * spec.macs_per_token, f"{spec.name}: MACs")
    t0 = time.perf_counter()
    _, cnt_wd = cn.net.run_batch(xs_w, compute="dense")
    torch.cuda.synchronize()
    dense_w_s = time.perf_counter() - t0
    for layer, a, b in zip(cn.net.layers, cnt_w, cnt_wd):
        for f in FIELDS:
            exact(getattr(a, f), getattr(b, f), f"{layer.name} {f}")
    profile_w = traced(lambda: cn.net.run_batch(
        xs_w, compute=EventCompute(mode="kernel")))
    attn_share = {layer.name: [float(live_tiles(a, b)[0].float().mean())
                               for a, b in ((x, layer.weights),
                                            (m, layer.w_mask))]
                  for layer, x, m, _ in rec_w.calls
                  if layer.name.endswith((".scores", ".values"))}
    emit({"phase": "frontend", "arch": "whisper-base", "seq_len": T_W,
          "fc_layers": n_fc,
          "weight_entries": sum(l.n_weights for l in cn.net.layers),
          "synapses": sum(l.w_nnz for l in cn.net.layers),
          "attention_sites": len(cn.attn_specs),
          "compile_s": compile_s, "compile_includes": "host build of the "
          "weights, copy to the card, 18 attention probes",
          "run_batch_s": run_s, "dense_run_batch_s": dense_w_s,
          "tokens": T_W, "macs_per_token": cn.macs_per_token(),
          "launches": launches_f,
          "counters": "bit-identical to dense; MACs == T * macs_per_token",
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "traced_run_batch": profile_w,
          "live_share_value_counter": attn_share})
    del cn, xs_w, rec_w, out_w, cnt_w, cnt_wd
    torch.cuda.empty_cache()

    # ------------------------------------- (g) pricing of compiled nets
    # and of the three fixtures under the committed trained profile
    t0 = time.perf_counter()
    priced = {}
    trained = SparsityProfile.load(PROFILE_PATH)

    def compiled(arch, act_density=None):
        def build():
            cs = compile_network(arch, seed=0, device=DEVICE,
                                 act_density=act_density)
            return cs.net, cs.inputs(4, seed=5)
        return build

    def fc_profile_sparse():
        n = fc_network([32, 48, 48, 24], weight_density=1.0, seed=11,
                       device=DEVICE)
        return (trained.apply(n, seed=17),
                make_inputs(32, 0.3, 8, seed=12, device=DEVICE))

    def conv_fc_profile_event():
        specs_g = conv_specs(seed=23, fc_out=12, mask_density=None)
        n = trained.apply(network_from_numpy(specs_g, 8 * 8 * 2,
                                             device=DEVICE), seed=19)
        return n, make_inputs(n.in_size, 0.3, 6, seed=24, device=DEVICE)

    for arch, fixture, builder in (
            ("gemma2-2b", "model_lm_gemma2", compiled("gemma2-2b")),
            ("mamba2-1.3b", "model_ssm_mamba2", compiled("mamba2-1.3b")),
            ("olmoe-1b-7b", "model_moe_olmoe", compiled("olmoe-1b-7b")),
            ("whisper-base", "model_encdec_whisper",
             compiled("whisper-base")),
            ("fc_profile_sparse", "fc_profile_sparse", fc_profile_sparse),
            ("conv_fc_profile_event", "conv_fc_profile_event",
             conv_fc_profile_event),
            ("gemma2-2b, trained profile", "model_lm_gemma2_profile",
             compiled("gemma2-2b", trained))):
        golden = json.loads((ROOT / "tests" / "golden"
                             / f"{fixture}.json").read_text())
        net_g, xs_s = builder()
        require(golden["steps"] == xs_s.shape[0], f"{fixture}: steps")
        require([r["name"] for r in golden["layers"]]
                == [l.name for l in net_g.layers], f"{fixture}: layers")
        reps = {}
        for mode, cc in (("kernel", EventCompute(mode="kernel")),
                         ("dense", DenseCompute())):
            run = net_g.run_batch(xs_s, compute=cc)
            for row, c in zip(golden["layers"], run[1]):
                for f in FIELDS:
                    require(row[f] == int(getattr(c, f).to(torch.float64)
                                          .sum()),
                            f"{fixture} {mode} {row['name']} {f}")
            reps[mode] = simulate(net_g, xs_s, prof, precomputed=run)
        rk, rd = reps["kernel"], reps["dense"]
        rel_t = abs(rk.time_per_step - rd.time_per_step) / rd.time_per_step
        rel_e = (abs(rk.energy_per_step - rd.energy_per_step)
                 / rd.energy_per_step)
        require(rel_t <= REPORT_RTOL and rel_e <= REPORT_RTOL,
                f"{arch}: kernel vs dense report {rel_t}, {rel_e}")
        priced[arch] = {"fixture": fixture, "layers": len(net_g.layers),
                        "cores": rd.n_cores_active,
                        "time_per_step": rd.time_per_step,
                        "energy_per_step": rd.energy_per_step,
                        "bottleneck_stage": rd.bottleneck_stage,
                        "rel_diff_time": rel_t, "rel_diff_energy": rel_e}
    emit({"phase": "pricing", "profile": prof.name, "archs": priced,
          "counters": "equal to tests/golden (all nine fixtures), kernel "
                      "and dense",
          "wall_s": time.perf_counter() - t0})

    # --------------------------------------------- (h) flash attention
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    flash_err, sites, probe_s = 0.0, {}, {}
    for arch, seq in (("whisper-base", 448), ("gemma2-2b", 8192)):
        _, attn = lowering_spec(registry.get(arch).config, seq_len=seq)
        t1 = time.perf_counter()
        for spec in attn:
            out, ref = attention_probe(spec, seed=0, device=DEVICE)
            require(bool(torch.isfinite(out).all()), f"{spec}: non-finite")
            err = close(out, ref, 0.0, PROBE_ATOL, f"{arch} {spec.name}")
            flash_err = max(flash_err, err)
            key = (f"{arch} S={spec.seq} H={spec.heads}/{spec.kv_heads} "
                   f"hd={spec.head_dim} causal={spec.causal} "
                   f"window={spec.window} softcap={spec.softcap}")
            row = sites.setdefault(key, {"sites": 0, "max_abs_err": 0.0})
            row["sites"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
        torch.cuda.synchronize()
        probe_s[arch] = time.perf_counter() - t1
    n_probes = sum(r["sites"] for r in sites.values())
    require(n_probes == 44, f"{n_probes} attention sites, not 18 + 26")
    gen = torch.Generator(device=dev).manual_seed(13)
    edges = {}

    def edge(what, B, Sq, Skv, H, K, hd, q_mul=1.0, float64=False, **kw):
        """The kernel against its plain version on random q (times q_mul),
        k and v; with float64 (non-causal, no cap, H == K), both against
        softmax attention in float64 too."""
        nonlocal flash_err
        q = q_mul * torch.randn((B, Sq, H, hd), generator=gen, device=dev)
        k = torch.randn((B, Skv, K, hd), generator=gen, device=dev)
        v = torch.randn((B, Skv, K, hd), generator=gen, device=dev)
        out = flash_attention(q, k, v, **kw)
        require(bool(torch.isfinite(out).all()), f"{what}: non-finite")
        plain = flash_attention_ref(q, k, v, **kw)
        err = close(out, plain, 0.0, PROBE_ATOL, what)
        flash_err = max(flash_err, err)
        edges[what] = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "K": K,
                       "hd": hd, "q_mul": q_mul, **kw, "max_abs_err": err}
        if float64:
            s64 = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                               k.double()) / hd ** 0.5
            o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s64, -1),
                               v.double())
            edges[what].update(
                kernel_vs_float64=(out.double() - o64).abs().max().item(),
                plain_vs_float64=(plain.double() - o64).abs().max().item())

    edge("window that bites", 1, 8192, 8192, 8, 4, 256, causal=True,
         window=4096, softcap=50.0)
    edge("ragged Sq != Skv, padded keys", 1, 300, 1000, 8, 2, 64,
         causal=False)
    edge("recurrentgemma GQA 10/1", 1, 4096, 4096, 10, 1, 256, causal=True,
         window=2048)
    edge("hd 112 (kimi-k2 heads)", 1, 1000, 1000, 64, 8, 112, causal=True)
    edge("B = 2", 2, 1500, 1500, 8, 8, 64, causal=False)
    # scores of std 4, as trained attention has: a one-pass TF32 kernel
    # misses the plain version here by ~3e-3 (tests/test_torch_flash.py)
    edge("peaked scores (whisper encoder, q x 4, no cap)", 1, 1500, 1500, 8,
         8, 64, q_mul=4.0, float64=True, causal=False)
    edge("hd 36 (k steps zero-filled)", 1, 1000, 1000, 8, 2, 36, causal=True)
    edge("hd 3 (under one 16-byte chunk a row)", 1, 500, 700, 4, 4, 3,
         causal=False)
    edge("ragged Sq = Skv = 1000, non-causal", 1, 1000, 1000, 8, 8, 64,
         causal=False)
    torch.cuda.synchronize()
    launches_h = flash_attention.launches
    require(launches_h == n_probes + len(edges),
            f"flash launches {launches_h} != {n_probes} + {len(edges)}")
    emit({"phase": "attention", "probes": n_probes, "sites": sites,
          "probe_s": probe_s, "edge_cases": edges, "launches": launches_h,
          "max_abs_err": flash_err, "atol": PROBE_ATOL,
          "wall_s": time.perf_counter() - t0})

    # ---------------------------------------------- (i) flash times
    def library_attention(q, k, v, causal, softcap):
        """One PyTorch call computing the same attention, as (name, call):
        scaled_dot_product_attention, or, for a tanh softcap, which it
        lacks, flex_attention compiled by Inductor with the cap as its
        score_mod and a causal block mask."""
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        if softcap is None:
            return "scaled_dot_product_attention", lambda: (
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
                .transpose(1, 2))
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        mask = (create_block_mask(lambda b, h, i, j: i >= j, None, None,
                                  q.shape[1], k.shape[1], device=dev)
                if causal else None)

        def cap(s, b, h, i, j):
            return softcap * torch.tanh(s / softcap)
        flex = torch.compile(flex_attention, dynamic=False)
        return "flex_attention (torch.compile)", lambda: flex(
            qt, kt, vt, score_mod=cap, block_mask=mask,
            enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)

    def time_flash(what, B, S, H, K, hd, causal, softcap, reps):
        """Launch-alone, wrapper, plain and library times of one attention
        call, with its bound: q, k, v read once, o written once, and
        4 * hd flops per live (query, key) pair per head."""
        g = torch.Generator(device=dev).manual_seed(17)
        q = torch.randn((B, S, H, hd), generator=g, device=dev)
        k = torch.randn((B, S, K, hd), generator=g, device=dev)
        v = torch.randn((B, S, K, hd), generator=g, device=dev)
        kw = dict(causal=causal, softcap=softcap)
        launch, out = bind_launch(q, k, v, **kw)
        build.check(launch(), "flash_attn")
        plain = flash_attention_ref(q, k, v, **kw)
        exact(out[:, :S], flash_attention(q, k, v, **kw), f"{what} launch")
        name, library = library_attention(q, k, v, causal, softcap)
        t1 = time.perf_counter()
        lib_err = close(library(), plain, 0.0, PROBE_ATOL, f"{what} {name}")
        torch.cuda.synchronize()
        lib_first_s = time.perf_counter() - t1
        del plain
        live = S * (S + 1) // 2 if causal else S * S
        flops = 4 * B * H * hd * live
        nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * K * hd)
        # 3xTF32: three TF32 products per multiply-add
        t_bytes, t_ops = (nbytes / PEAK_BYTES_PER_S,
                          3 * flops / PEAK_TF32_FLOPS)
        return {"what": what, "B": B, "S": S, "H": H, "K": K, "hd": hd,
                "causal": causal, "softcap": softcap, "bytes": nbytes,
                "flops": flops, "live_pairs_per_head": live,
                "method": "3xTF32",
                "fp32_fma_bound_ms": 1e3 * max(t_bytes,
                                               flops / PEAK_FP32_FLOPS),
                "ms": time_ms(launch, reps),
                "wrapper_ms": time_ms(lambda: flash_attention(q, k, v, **kw),
                                      reps),
                "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v,
                                                                **kw), reps),
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "library_ms": time_ms(library, reps), "library_call": name,
                "library_max_abs_err": lib_err,
                "library_first_call_s": lib_first_s}

    fa_rows = [time_flash("whisper encoder site", 1, 1500, 8, 8, 64, False,
                          None, 20),
               time_flash("whisper decoder self-attention site", 1, 448, 8,
                          8, 64, True, None, 20),
               time_flash("gemma2 global site", 1, 8192, 8, 4, 256, True,
                          50.0, 3)]
    emit({"phase": "times_flash", "card": card, "flash_attn": fa_rows,
          "ptxas": flash_ptxas(build.BUILD_DIR / "build.log")})
    fa = {"name": "flash_attn", "route": "cuda",
          "source": "src/repro_torch/csrc/flash_attn.cu",
          "replaces": "src/repro/kernels/flash_attn/kernel.py:29",
          "launches": launches_f["flash_attn"], "max_abs_err": flash_err}
    fa.update({k: fa_rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "fp32_fma_bound_ms", "method")})

    # ------------------------------- (j) the public kernel API, driven
    # The reference's public entry point (repro.kernels) on the slice-1
    # cell's own streams: sigma-delta encode fc0's activations against the
    # state one step behind, then the event-driven products of the
    # messages (values and counters) with fc1's weights, and fc0's own
    # product, without weight-tile occupancy (the 1-D kernel).
    layer0, x0, m0, _ = fc0_call
    layer1, d1, acc1 = fc1_delta
    a_fc0 = acc1[None, :] + torch.cumsum(d1, dim=0)     # (T, 2048)
    s_fc0 = torch.cat([torch.zeros_like(a_fc0[:1]), a_fc0[:-1]])
    api = {"event_matmul2": event_matmul2, "window_cumsum": window_cumsum,
           "flash_attn": flash_attention, "event_matmul": event_matmul,
           "sigma_delta_encode": sigma_delta_encode}
    for fn in api.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_fc0, s_new = kernels_api.sigma_delta_encode(a_fc0, s_fc0, theta=THETA)
    y_q, macs_q = kernels_api.event_matmul_pair(
        q_fc0, (q_fc0 != 0).to(torch.float32), layer1.weights,
        layer1.w_mask)
    y_x0 = kernels_api.event_matmul(x0, layer0.weights)
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t0
    launches_j = {k: fn.launches for k, fn in api.items()}
    expect_j = {"event_matmul2": 0, "window_cumsum": 0, "flash_attn": 0,
                "event_matmul": 3, "sigma_delta_encode": 1}
    require(launches_j == expect_j,
            f"kernel API launches {launches_j} != {expect_j}")
    n_msgs = int((q_fc0 != 0).sum())
    require(0 < n_msgs < q_fc0.numel(), "sigma-delta messages: none or all")
    exact(macs_q, (q_fc0 != 0).to(torch.float32) @ layer1.w_mask,
          "API counters vs dense")
    for v in (q_fc0, s_new, y_q, y_x0):
        require(bool(torch.isfinite(v).all()), "kernel API: non-finite")
    emit({"phase": "kernel_api", "entry": "repro_torch.kernels",
          "calls": ["sigma_delta_encode(fc0 activations, state one step "
                    "behind, theta=0.05)",
                    "event_matmul_pair(messages, fc1 weights), no w_occ",
                    "event_matmul(fc0 input, fc0 weights), no w_occ"],
          "shapes": {"a": list(a_fc0.shape), "fc1_w": list(
              layer1.weights.shape), "fc0_x": list(x0.shape)},
          "messages": n_msgs, "message_density": n_msgs / q_fc0.numel(),
          "launches": launches_j, "wall_s": api_s,
          "counters": "bit-identical to dense"})

    # -------------------------------- (k) kernels 3 and 4 vs plain, card
    t0 = time.perf_counter()
    em_err = {"float32": 0.0, "bfloat16": 0.0}
    rng = np.random.default_rng(21)
    keep = torch.as_tensor(rng.random((T // TILE, sizes[0] // TILE)) < 0.25,
                           device=dev)
    x_q = x0 * keep.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
    gw = torch.Generator(device=dev).manual_seed(23)
    em_cases = {"fc0 float32, all live": (x0, layer0.weights),
                "fc0 float32, 25% live": (x_q, layer0.weights),
                "fc0 bfloat16, 25% live": (x_q.to(torch.bfloat16),
                                           layer0.weights.to(
                                               torch.bfloat16)),
                "whisper-base fc2 shape, M = 448, float32": (
                    torch.relu(torch.randn((448, 2048), generator=gw,
                                           device=dev)),
                    torch.randn((2048, 512), generator=gw, device=dev)
                    / 2048 ** 0.5)}
    em_rows = {}
    # phase (j)'s value product: fc1's shape on the encoded message stream
    em_err["float32"] = close(y_q, event_matmul_ref(
        _pad_to(q_fc0, (TILE, TILE)), _pad_to(layer1.weights, (TILE, TILE)),
        threshold=0.0, bm=TILE, bk=TILE)[:q_fc0.shape[0],
                                         :layer1.weights.shape[1]],
        *EM_TOL["float32"], "kernel API fc1 pair values")
    em_rows["fc1 pair (sigma-delta messages)"] = {
        "max_abs_err": em_err["float32"],
        "live_tile_share": float(block_activity(q_fc0, 0.0).float().mean())}
    for what, (xc, wc_) in em_cases.items():
        yk = event_matmul(xc, wc_)
        yp = event_matmul_ref(_pad_to(xc, (TILE, TILE)),
                              _pad_to(wc_, (TILE, TILE)), threshold=0.0,
                              bm=TILE, bk=TILE)[:xc.shape[0], :wc_.shape[1]]
        require(yk.dtype == xc.dtype, f"{what}: output type {yk.dtype}")
        dt = "bfloat16" if xc.dtype == torch.bfloat16 else "float32"
        rt, at = EM_TOL[dt]
        err = close(yk, yp, rt, at, f"event_matmul {what}")
        em_err[dt] = max(em_err[dt], err)
        live = float(block_activity(xc, 0.0).float().mean())
        em_rows[what] = {"max_abs_err": err, "live_tile_share": live}
    # the 1-D pair on fc0's teacher-forced value and counter operands
    ones = torch.ones((sizes[0] // TILE, sizes[1] // TILE), dtype=torch.bool,
                      device=dev)
    y1, macs1 = event_matmul_pair(x0, m0, layer0.weights, layer0.w_mask)
    y2, macs2 = event_matmul_pair(x0, m0, layer0.weights, layer0.w_mask, ones)
    exact(macs1, m0 @ layer0.w_mask, "1-D pair counters vs dense")
    exact(macs1, macs2, "1-D pair counters vs event_matmul2")
    em_err["float32"] = max(em_err["float32"], close(
        y1, event_matmul_ref(x0, layer0.weights, threshold=0.0, bm=TILE,
                             bk=TILE), *EM_TOL["float32"],
        "1-D pair values"))
    em_rows["fc0 pair (teacher-forced)"] = {
        "counters": "bit-identical to dense m @ wm and to event_matmul2",
        "values_bit_identical_to_event_matmul2": bool(torch.equal(y1, y2))}
    # kernel 4: fc0's activation stream and whisper-base's widest map
    a_w = torch.relu(torch.randn((1500, 2048), generator=gw, device=dev))
    s_w = torch.cat([torch.zeros_like(a_w[:1]), a_w[:-1]])
    sd_cases = {"fc0 activations (1024, 2048) float32": (a_fc0, s_fc0),
                "whisper (1500, 2048) float32": (a_w, s_w),
                "whisper (1500, 2048) bfloat16": (a_w.to(torch.bfloat16),
                                                  s_w.to(torch.bfloat16))}
    sd_rows, sd_err = {}, 0.0
    for what, (ac, sc) in sd_cases.items():
        qk, sk = sigma_delta_encode(ac, sc, theta=THETA)
        qp, sp = sigma_delta_ref(ac, sc, theta=THETA)
        exact(qk, qp, f"sigma_delta {what} q")
        exact(sk, sp, f"sigma_delta {what} s'")
        sd_err = max(sd_err, *(float((k_.float() - p_.float()).abs().max())
                               for k_, p_ in ((qk, qp), (sk, sp))))
        nz = int((qk != 0).sum())
        require(0 < nz < qk.numel(), f"sigma_delta {what}: q all or none")
        sd_rows[what] = {"messages": nz, "density": nz / qk.numel()}
    torch.cuda.synchronize()
    emit({"phase": "kernels_api_check", "event_matmul": em_rows,
          "event_matmul_max_abs_err": em_err,
          "tolerances": {k: list(v) for k, v in EM_TOL.items()},
          "sigma_delta_encode": sd_rows,
          "sigma_delta_tolerance": "q and s' bit-identical",
          "sigma_delta_max_abs_err": sd_err,
          "wall_s": time.perf_counter() - t0})

    # ------------------------------------------ (l) kernel 3 and 4 times
    def time_em(what, x, w) -> dict:
        """Launch-alone, wrapper, plain and torch.matmul times of one 1-D
        event_matmul call, with its bounds from this call's live tiles
        (:func:`matmul_bound`: every n tile of a live activation tile is
        live; float32 by 3xTF32 at the TF32 rate, bfloat16 at its own).
        The wrapper lays the weights out per call; ``ms`` is the launch
        alone on weights laid out once."""
        xp, wp = _pad_to(x, (TILE, TILE)), _pad_to(w, (TILE, TILE))
        active = block_activity(xp, 0.0)
        nb = wp.shape[1] // TILE
        live = active[:, None, :].expand(-1, nb, -1)
        bf = x.dtype == torch.bfloat16
        launch, _ = em_bind_launch(x, KernelWeights(w))
        return {"what": what, "M": x.shape[0], "K": x.shape[1],
                "N": w.shape[1], "dtype": str(x.dtype).split(".")[-1],
                "live_tiles": int(active.sum()), "tiles": active.numel(),
                "splits": launch.splits,
                **matmul_bound(x.shape[0], w.shape[1], live,
                               x.element_size(), x.element_size(),
                               PEAK_BF16_FLOPS if bf else PEAK_TF32_FLOPS,
                               1 if bf else 3),
                "method": "bf16" if bf else "3xTF32",
                "ms": time_ms(launch),
                "cold_l2_ms": time_ms_cold(launch),
                "wrapper_ms": time_ms(lambda: event_matmul(x, w)),
                "plain_ms": time_ms(lambda: event_matmul_ref(
                    xp, wp, threshold=0.0, bm=TILE, bk=TILE)),
                "library_ms": time_ms(lambda: torch.matmul(xp, wp)),
                "library_call": "torch.matmul"}

    def time_sd(what, a, s) -> dict:
        """Launch-alone, wrapper and plain times of one sigma_delta_encode
        call, with its bound: a and s read once, q and s' written once,
        six operations per element at the fp32 rate.  No single PyTorch
        call computes the encoder, so there is no library time.  ``ms`` is
        the launch with a cold L2: back to back, a working set under 50 MB
        stays in L2 and the warm time (``warm_l2_ms``) can beat the HBM
        bound."""
        q, so = torch.empty_like(a), torch.empty_like(s)
        n = a.numel()
        nbytes = 4 * n * a.element_size()
        ops = 6 * n
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
        bf = int(a.dtype == torch.bfloat16)

        def launch():
            return lib.sigma_delta_launch(a.data_ptr(), s.data_ptr(),
                                          q.data_ptr(), so.data_ptr(), n,
                                          THETA, bf, stream)
        return {"what": what, "shape": list(a.shape),
                "dtype": str(a.dtype).split(".")[-1], "bytes": nbytes,
                "ops": ops, "ms": time_ms_cold(launch),
                "warm_l2_ms": time_ms(launch),
                "wrapper_ms": time_ms(lambda: sigma_delta_encode(
                    a, s, theta=THETA)),
                "plain_ms": time_ms(lambda: sigma_delta_ref(a, s,
                                                            theta=THETA)),
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "library_ms": None,
                "library_call": "none: no single PyTorch call computes the "
                                "fused encoder"}

    em_times = [time_em(w, *em_cases[w]) for w in em_cases]
    sd_times = [time_sd(w, *sd_cases[w]) for w in sd_cases]
    emit({"phase": "times_api", "card": card,
          "peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                    "fp32_flops_per_s": PEAK_FP32_FLOPS,
                    "tf32_flops_per_s": PEAK_TF32_FLOPS,
                    "bf16_flops_per_s": PEAK_BF16_FLOPS,
                    "source": "NVIDIA H100 SXM data sheet"},
          "event_matmul": em_times, "sigma_delta_encode": sd_times})
    em1 = {"name": "event_matmul", "route": "cuda",
           "source": "src/repro_torch/csrc/event_matmul.cu",
           "replaces": "src/repro/kernels/event_matmul/kernel.py:33",
           "launches": launches_j["event_matmul"],
           "max_abs_err": em_err["float32"]}
    em1.update({k: em_times[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "fp32_fma_bound_ms", "method")})
    sdk = {"name": "sigma_delta_encode", "route": "cuda",
           "source": "src/repro_torch/csrc/sigma_delta.cu",
           "replaces": "src/repro/kernels/sigma_delta/kernel.py:27",
           "launches": launches_j["sigma_delta_encode"],
           "max_abs_err": sd_err}
    sdk.update({k: sd_times[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")})

    # ----------------------- (m) population pricing at the slice-1 cell
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_p = net.run_batch(xs, compute=EventCompute(mode="kernel"))
    torch.cuda.synchronize()
    run_p_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = precompute_pricing(net, xs, prof, precomputed=run_p)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    parts = [part]
    for h in res.history:
        if h.partition not in parts:
            parts.append(h.partition)
    rng = np.random.default_rng(31)
    cands = [(p_, mk(p_, prof)) for p_ in parts
             for mk in (ordered_mapping, strided_mapping)]
    while len(cands) < K_POP:
        p_ = parts[len(cands) % len(parts)]
        cands.append((p_, random_mapping(p_, prof, rng)))
    ev_np = SimEvaluator(net, xs, prof, cache=cache)
    ev_dev = SimEvaluator(net, xs, prof, cache=cache,
                          population_backend="device")
    torch.cuda.reset_peak_memory_stats()
    pop_s = {}
    t0 = time.perf_counter()
    r_np = ev_np.evaluate_population(cands)
    torch.cuda.synchronize()
    pop_s["numpy"] = time.perf_counter() - t0
    peak_np = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r_dev = ev_dev.evaluate_population(cands)
    torch.cuda.synchronize()
    pop_s["device_first"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_dev = ev_dev.evaluate_population(cands)
    torch.cuda.synchronize()
    pop_s["device"] = time.perf_counter() - t0
    peak_dev = torch.cuda.max_memory_allocated()
    require(ev_np.n_evals == K_POP and ev_dev.n_evals == 2 * K_POP,
            f"evaluations {ev_np.n_evals}, {ev_dev.n_evals}")
    require(ev_dev.demotions == [] and ev_dev.active_backend == "device",
            f"device pricing demoted: {ev_dev.demotions}")
    pop_err = reports_close(r_dev, r_np, POP_RTOL)
    spot = np.linspace(0, K_POP - 1, 16).astype(int)
    for i in spot:
        p_, m_ = cands[i]
        same = simulate(net, xs, prof, p_, m_, precomputed=run_p)
        require(reports_identical(r_np[i], same),
                f"candidate {i}: numpy backend is not simulate's bits")
    emit({"phase": "population", "candidates": K_POP,
          "partitions": [list(p_.cores) for p_ in parts],
          "mappings": "ordered and strided for each partition, the rest "
                      "random (numpy seed 31)",
          "functional_run_s": run_p_s, "cache_build_s": cache_s,
          "wall_s": pop_s,
          "candidates_per_s": {k: K_POP / v for k, v in pop_s.items()},
          "peak_device_bytes": {"numpy": peak_np, "device": peak_dev},
          "device_vs_numpy_max_rel_err": pop_err, "rtol": POP_RTOL,
          "simulate_bit_identical": len(spot),
          "n_evals": {"numpy": ev_np.n_evals, "device": ev_dev.n_evals},
          "best_time_per_step": min(r.time_per_step for r in r_np)})

    # ----------------------------------- (n) guidance at the slice-1 cell
    t0 = time.perf_counter()
    guide = {}
    for what, (p_, m_) in (("minimal, ordered", (part, None)),
                           ("greedy result", (res.partition, res.mapping))):
        gs = floorline_layer_guidance(net, xs, prof, p_, m_, cache=cache)
        w_ = np.array([g.weight for g in gs])
        require(np.isfinite(w_).all() and abs(w_.mean() - 1.0) < 1e-9,
                f"guidance weights {w_}")
        guide[what] = [{"layer": g.name, "state": g.state.value,
                        "weight": g.weight, "mem_time": g.stage.mem_time,
                        "act_time": g.stage.act_time,
                        "traffic_time": g.stage.traffic_time}
                       for g in gs]
    emit({"phase": "guidance", "layers": guide,
          "wall_s": time.perf_counter() - t0})

    # ------------- (o)-(q) trained profile, search, resume at the cell
    del cache, run_p, ev_np, ev_dev, r_np, r_dev
    torch.cuda.empty_cache()
    search_phases(net, xs, prof, ckpt_root=build.BUILD_DIR / "ckpt",
                  expect_launches=expect, card=card)

    emit({"kernels": [mm, wc, fa, em1, sdk]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
