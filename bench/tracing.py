"""The benchmark's own spans, and the reduction of a profiler trace.

Spans are recorded from the benchmark's files around its calls into the
program's layers: the frontend's ``compile_network``, each
``run_batch``, and each call the network makes into the layer-compute
backend, through a subclass of the port's ``EventCompute`` kept here.

:class:`Profile` follows ``chip_smoke.traced()`` (commit cbf4587):
device operations from ``torch.profiler``'s trace, here taken from the
raw kineto events so that they keep their times: the union of device
activity over the traced window, the top device operations, the device
seconds of named kernels, and the idle gaps labelled by what the host
was doing.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

#: The benchmark's span names for the layer-compute calls.
COMPUTE_SPANS = {"forward": "compute.forward",
                 "delta_forward": "compute.delta_forward",
                 "value_forward": "compute.value_forward"}
RUN_BATCH_SPAN = "run_batch"
WINDOW_SPAN = "trace.window"
#: Every profiler range the benchmark opens: never device work itself.
LABELS = {RUN_BATCH_SPAN, WINDOW_SPAN, *COMPUTE_SPANS.values()}


class Spans:
    """Host-clock spans kept in memory: (name, start, end, job)."""

    def __init__(self):
        self.items: list[tuple[str, float, float, int | None]] = []
        self.job: int | None = None

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1, self.job))

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1, _ in self.items if n == name)


def traced_compute(event_compute_cls, spans: Spans, **kwargs):
    """An instance of a subclass of the port's ``EventCompute`` that puts
    a span (and a profiler range) around each outermost call the network
    makes into it, and, while ``.record`` is a list, keeps every
    product's operands there: ``("pair", layer, x, mask)`` for a value
    and a counter product, ``("value", layer, x)`` for a value product
    alone."""
    from torch.profiler import record_function

    class TracedEventCompute(event_compute_cls):
        def __init__(self):
            super().__init__(**kwargs)
            self.depth = 0
            self.record = None

        def _span(self, name, fn, *args):
            if self.depth:
                return fn(*args)
            self.depth += 1
            t0 = time.perf_counter()
            try:
                with record_function(name):
                    return fn(*args)
            finally:
                self.depth -= 1
                spans.add(name, t0, time.perf_counter())

        def forward(self, layer, x_eff, act_mask, msgs_in):
            if self.record is not None:
                self.record.append(("pair", layer, x_eff, act_mask))
            return self._span(COMPUTE_SPANS["forward"], super().forward,
                              layer, x_eff, act_mask, msgs_in)

        def delta_forward(self, layer, x_in, in_acc, act_mask, msgs_in):
            return self._span(COMPUTE_SPANS["delta_forward"],
                              super().delta_forward, layer, x_in, in_acc,
                              act_mask, msgs_in)

        def value_forward(self, layer, x_eff):
            if self.record is not None:
                self.record.append(("value", layer, x_eff))
            return self._span(COMPUTE_SPANS["value_forward"],
                              super().value_forward, layer, x_eff)

    return TracedEventCompute()


def _merge(intervals: list[tuple[int, int]]) -> list[list[int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class _Innermost:
    """Which of a set of host intervals covers a time, innermost first."""

    def __init__(self, items: list[tuple[int, int, str]]):
        self.items = sorted(items)
        self.starts = [s for s, _, _ in self.items]

    def at(self, t: int, scan: int = 512) -> str | None:
        i = bisect.bisect_right(self.starts, t)
        for s, e, name in reversed(self.items[max(0, i - scan):i]):
            if e >= t:
                return name
        return None


class Profile:
    """Device activity of one traced window: the window is the
    ``trace.window`` range of the trace, or, for a trace taken with device
    activity alone, ``window_s`` seconds of the host's clock around the
    whole trace."""

    def __init__(self, prof, window_s: float | None = None):
        events = prof.profiler.kineto_results.events()
        annotations, host_ops, device = [], [], []
        for e in events:
            kind = str(e.device_type())
            start, dur = int(e.start_ns()), int(e.duration_ns())
            if e.is_user_annotation():
                if kind.endswith("CPU"):
                    annotations.append((start, start + dur, e.name()))
                continue
            if kind.endswith("CPU"):
                host_ops.append((start, start + dur, e.name()))
            elif dur > 0 and e.name() not in LABELS:
                device.append((start, start + dur, e.name()))
        windows = [(s, e) for s, e, n in annotations if n == WINDOW_SPAN]
        if windows:
            self.w0, self.w1 = windows[0]
            device = [(max(s, self.w0), min(e, self.w1), n)
                      for s, e, n in device if e > self.w0 and s < self.w1]
        elif window_s is not None:
            self.w0 = min((s for s, _, _ in device), default=0)
            self.w1 = self.w0 + int(window_s * 1e9)
        else:
            raise RuntimeError(f"no {WINDOW_SPAN!r} range in the trace")
        self.device = device
        self.busy = _merge([(s, e) for s, e, _ in self.device])
        self._annotations = _Innermost(
            [a for a in annotations if a[2] != WINDOW_SPAN])
        self._host_ops = _Innermost(host_ops)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def device_seconds(self, parts: tuple[str, ...]) -> float:
        """Device seconds of the operations whose names hold any of
        ``parts``."""
        return sum(e - s for s, e, n in self.device
                   if any(p in n for p in parts)) * 1e-9

    def top_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, int] = defaultdict(int)
        for s, e, name in self.device:
            by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device seconds in the window, summed by what the host was
        doing in the middle of each gap: the innermost benchmark span
        (``network`` inside ``run_batch`` but outside the compute calls,
        ``harness`` outside ``run_batch``) and the innermost host operation."""
        edges = [self.w0] + [t for iv in self.busy for t in iv] + [self.w1]
        by_label: dict[str, int] = defaultdict(int)
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            span = self._annotations.at(mid)
            span = {None: "harness", RUN_BATCH_SPAN: "network"}.get(span, span)
            op = self._host_ops.at(mid) or "python"
            by_label[f"{span}:{op}"] += e - s
        top = sorted(by_label.items(), key=lambda kv: -kv[1])[:n]
        return [[label[:120], ns * 1e-9] for label, ns in top]
