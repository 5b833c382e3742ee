"""In-process spans and counts of the simulation path.

The frontend, the network, the layer-compute call and the event-matmul
wrapper open spans where their work happens (``frontend.draw``,
``network.run_batch``, ``network.layer``, ``compute.forward``,
``event_matmul.bind``, ...) and add counts to them.  Nothing is kept
unless a :func:`recording` is open::

    from repro_torch import trace

    with trace.recording() as rec:
        net.run_batch(xs, compute=EventCompute(mode="kernel"))
    rec.total("network.neuron")             # seconds
    rec.self_seconds("compute.forward")     # less the spans inside it
    rec.count("event_matmul2.live_tiles")

Off, :func:`span` reads one module global and returns one shared no-op
object: no clock, no profiler range, no allocation; :func:`count` returns
at once.  On, each span keeps its name, start and end, the index of its
parent (the innermost span open), a request id shared by every span
under one :func:`request` span (one ``run_batch``), and its attributes.
Times are ``time.time_ns()``, the clock of ``torch.profiler``'s kineto
events; while a profiler records, each span also opens a
``record_function`` range of its name, so every kernel in the trace links
to the span that launched it.  A count may be a 0-d device tensor, or a
pair of tensors whose product is summed: either is reduced once, when
the recording closes, so a count never synchronises the device or adds
device work while the work runs.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import torch
import torch.autograd.profiler as _profiler

_clock = time.time_ns
_record: "Record | None" = None


class _Noop:
    """The one span every call returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    """One recorded span: ``name``, ``start`` / ``end`` (ns), ``parent``
    (index into :attr:`Record.spans` or None), ``request`` (None outside
    any request), ``attrs`` and, once the recording has closed, the
    summed ``counts`` added inside it (name -> value; None for none)."""

    __slots__ = ("name", "attrs", "start", "end", "index", "parent",
                 "request", "counts", "_rec", "_new_request", "_range")

    def __init__(self, rec: "Record", name: str, attrs: dict,
                 new_request: bool):
        self.name, self.attrs, self._rec = name, attrs, rec
        self._new_request = new_request
        self.start = self.end = self.index = None
        self.parent = self.request = self.counts = None
        self._range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = rec.stack
        if stack:
            self.parent = stack[-1].index
            self.request = stack[-1].request
        if self._new_request:
            self.request = rec.requests
            rec.requests += 1
        self.index = len(rec.spans)
        stack.append(self)
        rec.spans.append(self)
        # stamped before the range opens: a process's first range takes
        # the profiler's set-up after its own start
        self.start = _clock()
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._rec.stack.pop()
        return False


def _reduce(values: list) -> list:
    """``values`` with every tensor entry made a number: a 0-d tensor its
    value, a pair ``(a, b)`` the sum of ``a * b``.  Entries of one shape,
    device and type are reduced together, in one transfer."""
    groups: dict[tuple, list[int]] = defaultdict(list)
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            groups[(v.shape, v.device, v.dtype)].append(i)
        elif isinstance(v, tuple):
            a, b = v
            groups[(a.shape, b.shape, a.device, a.dtype, b.dtype)].append(i)
    out = list(values)
    for idx in groups.values():
        first = values[idx[0]]
        if isinstance(first, torch.Tensor):
            summed = torch.stack([values[i] for i in idx])
        else:
            nd = max(first[0].ndim, first[1].ndim)

            def stacked(j):
                t = torch.stack([values[i][j] for i in idx])
                # right-align each operand's shape, as ``a * b`` does
                return t.reshape(len(idx), *[1] * (nd + 1 - t.ndim),
                                 *t.shape[1:])
            summed = (stacked(0) * stacked(1)).reshape(len(idx), -1).sum(1)
        for i, v in zip(idx, summed.tolist()):
            out[i] = v
    return out


class Record:
    """What one :func:`recording` kept: ``spans`` in the order they
    opened (a parent before its children), ``requests`` ids issued, and
    ``counts`` added outside any span."""

    def __init__(self):
        self.spans: list[Span] = []
        self.stack: list[Span] = []
        self.requests = 0
        self.counts: dict[str, float] = {}
        self._pending: list[tuple[Span | None, str, object]] = []

    def _close(self) -> None:
        """Sum every count into its span (or the record)."""
        values = _reduce([v for _, _, v in self._pending])
        for (owner, name, _), v in zip(self._pending, values):
            if owner is None:
                counts = self.counts
            else:
                counts = owner.counts = owner.counts or {}
            counts[name] = counts.get(name, 0) + v
        self._pending = []

    # ------------------------------------------------------------ reading
    def _of(self, name: str, requests):
        return (s for s in self.spans if s.name == name
                and (requests is None or s.request in requests))

    def total(self, name: str, requests=None) -> float:
        """Seconds of the spans ``name`` in ``requests`` (all when None),
        each counted once: one inside another of its name is covered."""
        inside: list[bool] = []
        total = 0.0
        for s in self.spans:
            up = s.parent is not None and (
                inside[s.parent] or self.spans[s.parent].name == name)
            inside.append(up)
            if s.name == name and not up and (
                    requests is None or s.request in requests):
                total += s.seconds
        return total

    def self_seconds(self, name: str, requests=None) -> float:
        """Self time of the spans ``name``: their seconds less what their
        child spans cover (and with it the children's own bookkeeping,
        which lands in the parent)."""
        children: dict[int, float] = defaultdict(float)
        for s in self.spans:
            if s.parent is not None:
                children[s.parent] += s.seconds
        return sum(s.seconds - children[s.index]
                   for s in self._of(name, requests))

    def count(self, name: str, requests=None) -> float:
        """Sum of the counts ``name`` in the spans of ``requests`` (all
        spans and the record's own when None)."""
        total = self.counts.get(name, 0) if requests is None else 0
        for s in self.spans:
            if s.counts and (requests is None or s.request in requests):
                total += s.counts.get(name, 0)
        return total


def span(name: str, **attrs):
    """A context manager around one piece of work: a recorded
    :class:`Span` while a :func:`recording` is open, else a shared no-op."""
    rec = _record
    if rec is None:
        return _NOOP
    return Span(rec, name, attrs, False)


def request(name: str, **attrs):
    """:func:`span` that starts a new request: the spans opened inside it
    share its request id."""
    rec = _record
    if rec is None:
        return _NOOP
    return Span(rec, name, attrs, True)


def count(name: str, value) -> None:
    """Add ``value`` to the innermost open span's count ``name``: a
    number, a 0-d tensor, or a pair ``(a, b)`` of tensors that counts
    ``(a * b).sum()``, reduced when the recording closes.  Nothing while
    no recording is open."""
    rec = _record
    if rec is None:
        return
    stack = rec.stack
    rec._pending.append((stack[-1] if stack else None, name, value))


def enabled() -> bool:
    """Whether a recording is open: a caller builds a count's operands
    only then."""
    return _record is not None


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Record every span and count for the block; yields the
    :class:`Record`, complete once the block has closed."""
    global _record
    if _record is not None:
        raise RuntimeError("a trace recording is already open")
    rec = _record = Record()
    try:
        yield rec
    finally:
        _record = None
        rec._close()
