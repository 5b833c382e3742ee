"""Run one cell of the benchmark: set-up, the measured window, the traced
window, the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``BENCHMARK.json`` names the configuration's
file, ``bench/traffic/<traffic>.json`` is the mix, ``bench/limits/
<workload>.json`` holds the cell's limits and ``bench/metrics/<metric>.py``
the reader of each per-layer metric (``read(run) -> float | None``).

The program under test is ``repro_torch``: each job is one
``CompiledNetwork.net.run_batch(xs, compute=EventCompute(mode="kernel"))``
over a fresh stream, ended by ``torch.cuda.synchronize()``; the network
comes from ``compile_network`` at the configuration's published widths.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time
import traceback

import numpy as np
import torch

from bench import counting, lowering, reference, tracing, traffic

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: Job ids of the warm-up and the traced window, apart from the window's.
WARM_BASE, TRACE_BASE = 1 << 40, 1 << 41
EVENT_MATMUL_KERNELS = ("event_matmul_kernel", "reduce_splits")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: pathlib.Path = ROOT


def _in_cell(metric: dict, cell: str, reported: set[str] | None = None
             ) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, config_file: str, traffic_name: str,
              chips: int = 1, root: pathlib.Path = ROOT) -> Cell:
    """A cell from its files: the configuration at ``config_file``, the
    mix ``bench/traffic/<traffic_name>.json``, the limits ``bench/limits/
    <name>.json``, and the metrics of ``root/BENCHMARK.json`` that it
    reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / config_file).read_text())
    tr = json.loads((root / "bench" / "traffic"
                     / f"{traffic_name}.json").read_text())
    limits = json.loads((root / "bench" / "limits"
                         / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, name, names)]
    return Cell(name, chips, config, tr, limits, e2e, per_layer, root)


def find_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return load_cell(workload, configs[w["config"]]["file"], w["traffic"],
                     int(w["chips"]), root)


def file_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``<config>.<traffic>`` from ``bench/``'s files, whether
    ``BENCHMARK.json`` lists it or not (one chip)."""
    config, mix = name.rsplit(".", 1)
    return load_cell(name, f"bench/configs/{config}.json", mix, 1, root)


def port_config(cfg: dict):
    """The port's config dataclass for a configuration file's object."""
    from repro_torch.models.common import (BlockCfg, ModelCfg, MoECfg,
                                           RGLRUCfg, SSDCfg)
    from repro_torch.models.encdec import EncDecCfg

    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in d.items() if k in names}

    def block(b):
        kw = pick(BlockCfg, b)
        for key, cls in (("ssd", SSDCfg), ("moe", MoECfg),
                         ("rglru", RGLRUCfg)):
            if b.get(key) is not None:
                kw[key] = cls(**b[key])
        return BlockCfg(**kw)

    if cfg["kind"] == "encdec":
        return EncDecCfg(**pick(EncDecCfg, cfg))
    kw = pick(ModelCfg, cfg)
    for key in ("prefix", "pattern", "suffix"):
        kw[key] = tuple(block(b) for b in cfg.get(key, []))
    return ModelCfg(**kw)


def load_reader(metric: str, root: pathlib.Path = ROOT):
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def occupancy(spec: lowering.LayerSpec) -> np.ndarray:
    """(Kb, Nb) weight-tile occupancy of a frozen layer spec."""
    if spec.structure[0] == "dense":
        return np.ones((-(-spec.fanin // counting.TILE),
                        -(-spec.width // counting.TILE)), bool)
    return counting.tile_any(lowering.structure_mask(spec) != 0)


def _tile_activity(x: torch.Tensor) -> np.ndarray:
    """(Mb, Kb) map of 128-tiles of ``x`` that hold a nonzero."""
    t = counting.TILE
    m, k = x.shape
    nz = torch.nn.functional.pad(x != 0, (0, (-k) % t, 0, (-m) % t))
    mb, kb = nz.shape[0] // t, nz.shape[1] // t
    return nz.reshape(mb, t, kb, t).any(dim=3).any(dim=1).cpu().numpy()


def product_needs(records: list, specs: dict) -> list[counting.Need]:
    """What each recorded product of the traced window needs."""
    occ_cache: dict[str, np.ndarray] = {}
    needs = []
    for rec in records:
        layer = rec[1]
        spec = specs[layer.name]
        if layer.name not in occ_cache:
            occ_cache[layer.name] = occupancy(spec)
        occ = occ_cache[layer.name]
        for x, kind in zip(rec[2:], ("float32", "int8")):
            needs.append(counting.product_need(
                _tile_activity(x), occ, x.shape[0], spec.fanin, spec.width,
                kind))
    return needs


@dataclasses.dataclass
class Run:
    """What the per-layer readers read."""

    cell: Cell
    steps: int                      # simulated timesteps a job
    spans: tracing.Spans
    job_s: list[float]              # the window's job walls, in order
    window_jobs: int
    window_s: float
    macs_per_job: float | None
    profile: tracing.Profile | None
    needs: list[counting.Need]


def host_probe() -> float:
    """Seconds of a fixed pure-Python loop: the host's speed, beside the
    host-bound window (it swings from run to run on a shared host)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(3_000_000):
        acc += i * i
    return time.perf_counter() - t0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Mismatches:
    """Counts, in each precision, the counters that differ from the
    float64 reference's: the program's (under ``"program"``) and each
    other precision's, put in the program's place; and the reference's
    MACs of each checked stream."""

    def __init__(self, kept: dict):
        self.kept = kept
        self.count: dict[str, int] = {}
        self.macs: dict[int, float] = {}

    def _add(self, who: str, got, ref: dict) -> None:
        n = 0
        for name, r in ref.items():
            g = got(name).to(torch.float64)
            n += r.numel() if g.shape != r.shape else int((g != r).sum())
        self.count[who] = self.count.get(who, 0) + n

    def __call__(self, i, layer, sid, cnts):
        ref = cnts["float64"]
        self._add("program", lambda n: getattr(self.kept[sid][1][i], n), ref)
        for p, c in cnts.items():
            if p != "float64":
                self._add(p, c.__getitem__, ref)
        self.macs[sid] = self.macs.get(sid, 0.0) + float(ref["macs"].sum())


def verdict(checks: dict) -> bool:
    """``correct``: every number compared lies within its limit."""
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False) -> tuple[dict, dict]:
    """One run of ``cell``: returns the result object and the checks.

    With ``control`` the reference also runs in TF32, the precision
    below the configurations' float32, and its outputs and counters go
    through the same checks in the program's place: the result's
    ``control`` holds them and their verdict (for setting the limits;
    the benchmark's own runs never set it)."""
    from repro_torch.neuromorphic.compute import EventCompute
    from repro_torch.neuromorphic.frontend import compile_network

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    tr = traffic.with_defaults(cell.traffic)
    job_steps = int(tr["steps"]) * int(tr["streams_per_job"])
    spans = tracing.Spans()
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.load()                   # compiles on a checkout's first run

    t0 = time.perf_counter()
    compiled = compile_network(
        port_config(cell.config), seq_len=int(tr["seq_len"]), smoke=False,
        seed=seed, act_density=tr["act_density"],
        recurrent_neuron=tr["recurrent_neuron"], verify_attention=False,
        device=dev)
    spans.add("frontend.compile", t0, time.perf_counter())
    net = compiled.net
    compute = (tracing.traced_compute(EventCompute, spans, mode="kernel")
               if trace else EventCompute(mode="kernel"))

    k = int(tr["streams_per_job"])
    checked = traffic.checked_streams(tr, seed)
    kept: dict[int, tuple] = {}
    if trace:
        from torch.profiler import record_function
    else:
        from contextlib import nullcontext as record_function

    def job(first: int, keep=()) -> float:
        """Streams ``first .. first + k - 1`` back to back, ended by one
        synchronise: the job's wall seconds."""
        xs = [traffic.stream(tr, net.in_size, seed, first + s, dev)
              for s in range(k)]
        _sync(dev)
        t0 = time.perf_counter()
        for s, x in enumerate(xs):
            t1 = time.perf_counter()
            with record_function(tracing.RUN_BATCH_SPAN):
                out, cnts = net.run_batch(x, compute=compute)
            spans.add(tracing.RUN_BATCH_SPAN, t1, time.perf_counter())
            if first + s in keep:
                kept[first + s] = (out, cnts)
        _sync(dev)
        return time.perf_counter() - t0

    # set-up ends with as many streams' outputs held as the window holds,
    # so that the window allocates nothing new
    warm = range(WARM_BASE, WARM_BASE + k * int(tr["warm_jobs"]), k)
    for first in warm:
        job(first, keep=range(WARM_BASE, WARM_BASE + len(checked) + 1))
    kept.clear()
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    times: list[float] = []
    failed, error = 0, None
    w0 = time.perf_counter()
    while True:
        spans.job = len(times)
        try:
            times.append(job(k * len(times), keep=checked))
        except Exception:                       # a failed job ends the run
            failed, error = 1, traceback.format_exc()
            break
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    probe_s = host_probe()
    spans.job = None
    attempted = len(times) + failed
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if failed:
        print(error, file=sys.stderr)
    for sid in checked:              # answers the window did not reach
        if sid not in kept and not failed:
            job(sid - sid % k, keep=checked)

    profile, needs = None, []
    specs = lowering.lowering_spec(cell.config, seq_len=int(tr["seq_len"]),
                                   recurrent_neuron=tr["recurrent_neuron"])
    if trace and not failed:
        from torch.profiler import ProfilerActivity, profile as profiler
        traced = range(TRACE_BASE, TRACE_BASE + k * int(tr["trace_jobs"]), k)
        # one pass keeps the products' operands for their counts, a second
        # pass over the same streams is profiled without them
        compute.record = []
        for first in traced:
            job(first)
        needs = product_needs(compute.record, {s.name: s for s in specs})
        compute.record = None
        # device activity alone first: recording host operations costs
        # microseconds each and would stretch the window it measures;
        # then both, for what the host did in each idle gap
        device_acts = [ProfilerActivity.CUDA if dev.type == "cuda"
                       else ProfilerActivity.CPU]
        with profiler(activities=device_acts) as prof:
            t0 = time.perf_counter()
            for first in traced:
                job(first)
            traced_s = time.perf_counter() - t0
        profile = tracing.Profile(prof, window_s=traced_s)
        both = {ProfilerActivity.CPU, *device_acts}
        with profiler(activities=sorted(both, key=str)) as prof:
            with record_function(tracing.WINDOW_SPAN):
                for first in traced:
                    job(first)
        idle_gaps = tracing.Profile(prof).idle_gaps()

    prog_layers = [(l.name, l.fanin, l.n_neurons, l.neuron_model)
                   for l in net.layers]
    ref_layers = [(s.name, s.fanin, s.width, s.neuron_model) for s in specs]
    layer_mismatch = sum(a != b for a, b in zip(prog_layers, ref_layers)) \
        + abs(len(prog_layers) - len(ref_layers))
    del compiled, net, compute
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = {"failed_jobs": {"value": failed, "limit": 0},
              "layer_mismatch": {"value": layer_mismatch, "limit": 0}}
    macs_per_job = None
    control_result = None
    t_ref = time.perf_counter()
    if not failed and not layer_mismatch:
        streams = {j: traffic.stream(tr, cell.config["d_model"], seed, j,
                                     dev) for j in checked}
        mism = _Mismatches(kept)
        outs = reference.run(
            lowering.draw_network(specs, seed, tr["act_density"]), streams,
            dev, precisions=reference.PRECISIONS if control else ("float64",),
            on_layer=mism, bench_dir=cell.root / "bench")
        limit = float(cell.limits["out_gap"])

        def judged(who, got):
            return {"counter_mismatch": {"value": mism.count[who],
                                         "limit": 0},
                    "out_gap": {"value": max(
                        reference.gap(got[j], outs["float64"][j])
                        for j in checked), "limit": limit}}
        checks.update(judged("program", {j: kept[j][0] for j in checked}))
        if control:
            cchecks = judged("tf32", outs["tf32"])
            control_result = {"correct": verdict(cchecks), "checks": cchecks}
        macs_per_job = k * float(np.mean(list(mism.macs.values())))
    ref_s = time.perf_counter() - t_ref
    correct = verdict(checks)

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics: dict[str, dict] = {}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if not trace:
        values = {"setup_s": setup_s,
                  "sim_steps_per_s": job_steps * len(times) / window_s,
                  "job_p90_s": (float(np.percentile(times, 90))
                                if times else math.nan)}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        run = Run(cell=cell, steps=job_steps, spans=spans, job_s=times,
                  window_jobs=len(times), window_s=window_s,
                  macs_per_job=macs_per_job, profile=profile, needs=needs)
        for m in cell.per_layer:
            value = load_reader(m["name"], cell.root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if profile is not None:
            device_info["busy_s"] = profile.busy_s
            device_info["window_s"] = profile.window_s
            result["breakdown"] = {"device_ops": profile.top_ops(),
                                   "idle_gaps": idle_gaps}
    quartiles = (np.quantile(times, [0, 0.25, 0.5, 0.75, 1]).tolist()
                 if times else [])
    result["timing"] = {"setup_s": setup_s, "window_s": window_s,
                        "jobs": len(times), "job_s_quartiles": quartiles,
                        "host_probe_s": probe_s, "reference_s": ref_s}
    if control_result is not None:
        result["control"] = control_result
    result["checks"] = checks
    return result, checks
