"""Counts of the aten ops that one eager call dispatches: its matmul FLOPs,
HBM bytes and collective bytes per chip (PyTorch port of
``repro.core.hlo_cost``).

The reference re-derives per-chip costs from compiled HLO text, because
XLA's ``cost_analysis()`` counts each ``while`` body once.  The port has
no HLO: :func:`analyze` runs the call under a ``TorchDispatchMode`` and
counts every aten op as the card runs it.  The rules are the reference's:

  * FLOPs count matrix products only, ``2 * prod(result) * contraction``
    (``mm`` with its ``out_dtype`` overload, ``addmm``, ``bmm``,
    ``baddbmm``, the convolution and fused-attention overloads), by
    ``torch.utils.flop_counter``'s formulas.  Elementwise FLOPs are not
    counted: matrix products dominate every cell.
  * HBM bytes are each op's operand bytes plus its result bytes: eager
    mode fuses nothing, so every op's bytes reach HBM.  An operand is read
    once (a broadcast operand at most its storage's bytes).  An op whose
    result aliases an input (views, ``t``, ``expand``, ``detach``,
    ``_unsafe_view``) moves nothing — read from each op's schema, the
    counterpart of the reference's ``_NOBYTE_OPS``; an in-place op reads
    its operands and writes its result.
  * ``score_bytes``: the part of ``hbm_bytes`` moved by ops that touch an
    attention-score block, which a flash-attention kernel keeps on chip.
    The reference's ``_is_score_like`` takes any tensor whose two
    trailing dims are >= 512 and which holds >= 4 Mi elements; on one
    card that also takes weights (a (2304, 9216) MLP matrix), their
    gradients and optimizer state, activations and logits.  So here a
    score block must also have >= 4 dims (the port's scores are
    (B, K, G, Sq, Skv)) and trailing dims that are one of the caller's
    ``score_dims`` (queries, keys) pairs; with none given, nothing is a
    score.
  * Collective bytes are 0: the port runs on one card, and nothing here
    invents them.  ``bytes_by_kind``, ``count_by_kind`` and
    ``top_collectives`` (the collectives) stay empty.
  * Trip counts: the reference scales a ``while`` body by its trips.
    Here code run inside :meth:`Counter.trips` counts ``n`` times
    (``while_trips`` lists the multipliers applied), so a loop is run once
    and scaled — the train step's microbatch loop
    (``train.step.train_step_parts``).
  * ``peak_live_bytes``: the largest total of storages made inside the
    window and alive at once (each released when its storage dies).

The port's five CUDA kernels are bound through ctypes, so a dispatch mode
never sees them: :func:`analyze` raises if one launched inside its
window, rather than under-count silently.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# results that alias an input though their schema does not say so
_ALIASING = {torch.ops.aten._unsafe_view}
# allocations that write nothing
_NO_WRITE = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
             torch.ops.aten.empty_like}


def ported_kernels() -> dict:
    """The five ported kernels' wrappers by name; each counts its launches
    in ``.launches``."""
    from repro_torch.kernels.event_matmul.ops import (event_matmul,
                                                      event_matmul2)
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.sigma_delta.ops import (sigma_delta_encode,
                                                     window_cumsum)
    return {"event_matmul2": event_matmul2, "window_cumsum": window_cumsum,
            "flash_attn": flash_attention, "event_matmul": event_matmul,
            "sigma_delta": sigma_delta_encode}


def _is_score_like(shape, score_dims) -> bool:
    """An attention-score block: >= 4 dims whose trailing two are one of
    ``score_dims``' (queries, keys) pairs, and the reference's size floor
    (both trailing dims >= 512, >= 4 Mi elements)."""
    return (len(shape) >= 4 and tuple(shape[-2:]) in score_dims
            and shape[-1] >= 512 and shape[-2] >= 512
            and math.prod(shape) >= 4 * 2**20)


def _mutated(func, args, kwargs) -> list:
    """The tensors an op writes in place (its ``Tensor(a!)`` arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            out += [t for t in tree_leaves(v) if isinstance(t, torch.Tensor)]
    return out


def _read_bytes(t: torch.Tensor) -> int:
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    score_bytes: float = 0.0        # subset of hbm_bytes: on chip under a
                                    # flash-attention kernel
    collective_bytes: float = 0.0
    bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    count_by_kind: dict = dataclasses.field(default_factory=dict)
    while_trips: dict = dataclasses.field(default_factory=dict)
    top_collectives: list = dataclasses.field(default_factory=list)
    top_dots: list = dataclasses.field(default_factory=list)
    top_hbm: list = dataclasses.field(default_factory=list)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    n_ops: float = 0.0
    peak_live_bytes: int = 0


class Counter(TorchDispatchMode):
    """The dispatch mode behind :func:`analyze`; use it directly to scale
    part of a call with :meth:`trips`.  ``score_dims``: the (queries,
    keys) pairs of the call's attention-score blocks."""

    def __init__(self, score_dims=()):
        super().__init__()
        self.cost = HloCost()
        self._score_dims = frozenset(map(tuple, score_dims))
        self._mult = 1
        self._dots: dict[str, float] = collections.defaultdict(float)
        self._hbm: dict[str, float] = collections.defaultdict(float)
        self._lock = threading.Lock()
        self._live: dict[int, int] = {}
        self._live_bytes = 0

    @contextlib.contextmanager
    def trips(self, name: str, n: int):
        """Count what runs inside ``n`` times (a loop body run once)."""
        self.cost.while_trips[name] = n
        self._mult *= n
        try:
            yield
        finally:
            self._mult //= n

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key, n = s._cdata, s.nbytes()
        with self._lock:
            if key in self._live:
                return
            self._live[key] = n
            self._live_bytes += n
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                            self._live_bytes)
        weakref.finalize(s, self._release, key)

    def _release(self, key: int) -> None:
        with self._lock:
            self._live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        rets = func._schema.returns
        if packet in _ALIASING or (rets and all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in rets)):
            return out
        m = self._mult
        c = self.cost
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        shapes = ", ".join(str(tuple(t.shape)) for t in ins)
        label = f"x{m} {packet.__name__}({shapes})"
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += m * f
            dtype = str(ins[0].dtype).removeprefix("torch.")
            c.flops_by_dtype[dtype] = c.flops_by_dtype.get(dtype, 0) + m * f
            self._dots[label] += m * f
        in_keys = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in in_keys]
        written = 0 if packet in _NO_WRITE else sum(
            t.numel() * t.element_size() for t in fresh + _mutated(
                func, args, kwargs))
        moved = sum(map(_read_bytes, ins)) + written
        c.hbm_bytes += m * moved
        c.n_ops += m
        if any(_is_score_like(t.shape, self._score_dims)
               for t in ins + outs):
            c.score_bytes += m * moved
        self._hbm[label] += m * moved
        for t in fresh:
            self._track(t)
        return out

    def result(self) -> HloCost:
        top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:12]
        self.cost.top_dots = top(self._dots)
        self.cost.top_hbm = top(self._hbm)
        return self.cost


@contextlib.contextmanager
def counting(score_dims=()):
    """``with counting() as c: ...`` counts the block; ``c.result()`` is its
    :class:`HloCost`.  Raises if a ported kernel launched in the block."""
    kernels = ported_kernels()
    before = {k: fn.launches for k, fn in kernels.items()}
    counter = Counter(score_dims)
    with counter:
        yield counter
    launched = {k: fn.launches - before[k] for k, fn in kernels.items()
                if fn.launches != before[k]}
    if launched:
        raise RuntimeError(f"ported kernels launched inside the counted "
                           f"window, unseen by the count: {launched}")


def analyze(fn, *args, **kwargs) -> HloCost:
    """The :class:`HloCost` of one eager call ``fn(*args, **kwargs)``, with
    no score blocks (:func:`counting` takes them)."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.result()
