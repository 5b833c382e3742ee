"""Pluggable per-layer synaptic-compute backends for the simulator.

The simulator's hot path is the per-layer synaptic forward: consume the
``(T, n_in)`` effective-activation block, produce the ``(T, n_out)``
pre-activations plus the exact MAC / dense-fetch counter maps the cost
model prices.  :class:`SimLayer` delegates it to a :class:`LayerCompute`:

* ``"dense"`` (:class:`DenseCompute`, the default) — one ``torch.matmul``
  or one ``F.conv2d`` per layer.
* ``"event"`` (:class:`EventCompute`) — event-driven execution: a message
  is only sent for a nonzero activation, and only its weights are fetched.
  Three kernel modes share one semantic contract (skipped work is exactly
  event-free, so integer counters are bit-identical to dense and ``pre``
  agrees to float roundoff):

  - ``"kernel"`` — the hand-written CUDA kernels: the joint (activation x
    weight tile) block-sparse matmul, float32 for the values and int8 0/1
    masks for the exact counters, both products of a layer bound and run
    in one library call
    (:func:`repro_torch.kernels.event_matmul.ops.event_matmul_pair_packed`),
    under every option set, on weights transposed and padded once per
    layer, and the windowed delta reconstruction
    (:func:`repro_torch.kernels.sigma_delta.ops.window_reconstruct`).  On
    CPU tensors the kernel wrappers run their plain PyTorch versions.
  - ``"gather"`` — the column-granular host expression of the same
    contract: per ``gather_bm``-row tile the union of active input columns
    is compacted and only those weight rows enter one dense contraction.
  - ``"auto"`` picks ``kernel`` for layers on a CUDA device and ``gather``
    on the CPU.

Conv layers run event-driven through an im2col view whose patch rows feed
the same event matmul as fc layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels.event_matmul.ops import (KERNEL_TILE, KernelWeights,
                                                  event_matmul_packed,
                                                  event_matmul_pair_packed,
                                                  kernel_operand,
                                                  weight_block_occupancy)
from repro_torch.kernels.sigma_delta.ops import window_reconstruct

#: Backend used when a ``compute=`` argument is omitted.
DEFAULT_COMPUTE = "dense"


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 cumulative sum over dim 0, one row at a time: the addition
    order of ``np.cumsum`` and of the step-major delta accumulator.
    ``torch.cumsum`` accumulates float32 in float64 on the CPU and in a
    parallel scan on CUDA, and either can move a sigma-delta message."""
    out = torch.empty_like(x)
    acc = x[0].clone()
    out[0] = acc
    for t in range(1, x.shape[0]):
        acc = acc + x[t]
        out[t] = acc
    return out


class LayerCompute:
    """Backend protocol: the per-layer synaptic forward over a time batch.

    ``fc_forward`` / ``conv_forward`` consume the ``(T, n_in)``
    effective-activation block, the 0/1 wire-event mask and the per-step
    message counts, and return ``(pre, macs, fetches_dense)`` as
    ``(T, n_out)`` maps (channel-major flat for conv).

    Contract: ``macs`` and ``fetches_dense`` are exact event counts,
    bit-identical across backends; ``pre`` equals the dense reference to
    float roundoff (rtol <= 1e-6).
    """

    name = "?"

    def fc_forward(self, layer, x_eff, act_mask, msgs_in):
        raise NotImplementedError

    def conv_forward(self, layer, x_eff, act_mask, msgs_in):
        raise NotImplementedError

    def forward(self, layer, x_eff: torch.Tensor, act_mask: torch.Tensor,
                msgs_in: torch.Tensor):
        """Dispatch on the layer kind; the one entry point SimLayer calls."""
        if layer.kind == "fc":
            return self.fc_forward(layer, x_eff, act_mask, msgs_in)
        return self.conv_forward(layer, x_eff, act_mask, msgs_in)

    def delta_forward(self, layer, x_in: torch.Tensor, in_acc: torch.Tensor,
                      act_mask: torch.Tensor, msgs_in: torch.Tensor):
        """Forward for a layer whose upstream sends deltas: reconstruct the
        effective activation from the carried accumulator, run the synaptic
        forward, and return ``(pre, macs, fetches_dense, new_acc)``.

        The base implementation is the bit-exact reference: a sequential
        float32 cumulative sum over time, which matches the step-major
        addition order when the accumulator starts at zero.
        """
        if bool(in_acc.any()):
            x_eff = in_acc[None, :] + _seq_cumsum(x_in)
        else:
            x_eff = _seq_cumsum(x_in)
        new_acc = x_eff[-1].clone()
        pre, macs, fetches = self.forward(layer, x_eff, act_mask, msgs_in)
        return pre, macs, fetches, new_acc


def _fetches(msgs_in: torch.Tensor, shape) -> torch.Tensor:
    """Dense-format fetches: every input message fetches one weight word
    per output neuron."""
    return msgs_in.to(torch.float32)[:, None].expand(shape)


def _same_pads(layer) -> tuple[int, int, int, int]:
    """XLA "SAME" padding split (``lo = total // 2``) as an ``F.pad``
    tuple (left, right, top, bottom) for the layer's conv."""
    h, w = layer.in_hw
    kh, kw = layer.weights.shape[:2]
    oh, ow = layer.out_hw
    s = layer.stride
    pad_h = max(0, (oh - 1) * s + kh - h)
    pad_w = max(0, (ow - 1) * s + kw - w)
    return (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2)


# ------------------------------------------------------------------- dense

class DenseCompute(LayerCompute):
    """The dense path: one GEMM / one batched conv per layer."""

    name = "dense"

    def fc_forward(self, layer, x_eff, act_mask, msgs_in):
        pre = x_eff @ layer.weights
        macs = act_mask @ layer.w_mask
        return pre, macs, _fetches(msgs_in, macs.shape)

    def conv_forward(self, layer, x_eff, act_mask, msgs_in):
        """All-timesteps conv with batch = T, NCHW (the flat maps are
        channel-major on both sides).  The counter convs are rounded:
        their exact values are integers, and cuDNN may pick a transform
        algorithm (FFT / Winograd) that is off by float roundoff."""
        T = x_eff.shape[0]
        h, w = layer.in_hw
        cin = layer.weights.shape[2]
        pads = _same_pads(layer)
        wk, wmask, wones = layer._conv_kernels
        conv = lambda a, k: F.conv2d(F.pad(a.reshape(T, cin, h, w), pads),
                                     k, stride=layer.stride).reshape(T, -1)
        pre = conv(x_eff, wk)
        macs = torch.round(conv(act_mask, wmask))
        fetches = torch.round(conv(act_mask, wones))
        return pre, macs, fetches


# ------------------------------------------------------------------- event

def derived_from_weights(layer, key: str, builder):
    """Per-layer cache of data derived from ``layer.weights``, keyed on the
    identity of the weights tensor: a cached value is served only while
    ``layer.weights`` is still the same tensor object, so rebinding the
    weights invalidates every derived structure.  ``builder(layer)`` runs
    on a miss."""
    slot = layer.__dict__.get(key)
    if slot is None or slot[0] is not layer.weights:
        with trace.span("compute.pack"):
            trace.count("compute.packs", 1)
            slot = (layer.weights, builder(layer))
        layer.__dict__[key] = slot
    return slot[1]


def _patch_weights(layer) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Conv weights in im2col patch order: ``(kh, kw, cin, cout) ->
    (cin * kh * kw, cout)`` values + nnz mask + per-feature-row liveness,
    matching :func:`_im2col`'s (cin, kh, kw) feature layout."""
    def build(layer):
        wf = layer.weights.permute(2, 0, 1, 3).reshape(
            -1, layer.weights.shape[3]).contiguous()
        nz = wf != 0
        return wf, nz.to(torch.float32), nz.any(dim=1)
    return derived_from_weights(layer, "_patch_weights", build)


class _WeightBlocks:
    """Block-CSR weight-sparsity structure for one 2-D weight matrix
    ``w``: ``live`` (K,) bool marks weight rows with >= 1 nonzero; ``occ``
    is the (Kb, Nb) bool (bk, bn) weight-tile occupancy map on the
    weights' device."""

    __slots__ = ("w", "live", "occ", "bk", "bn", "_kernel")

    def __init__(self, w2: torch.Tensor, bk: int, bn: int):
        self.w, self.bk, self.bn = w2, bk, bn
        self.live = (w2 != 0).any(dim=1)
        self.occ = weight_block_occupancy(w2, bk, bn)
        self._kernel = None

    @classmethod
    def rows_only(cls, live: torch.Tensor) -> "_WeightBlocks":
        """Row-liveness-only structure (conv gather, where the patch-weight
        feature axis is compacted per call)."""
        wb = cls.__new__(cls)
        wb.w = wb._kernel = wb.bk = wb.bn = None
        wb.live = live
        wb.occ = torch.ones((1, 1), dtype=torch.bool, device=live.device)
        return wb

    def kernel_weights(self) -> tuple[KernelWeights, KernelWeights]:
        """The value weights (float32) and their nnz mask (int8) in the
        kernel's layout, both with ``occ`` (a structure at 128-wide tiles):
        built at first use, then cached with this structure, i.e. once per
        layer."""
        if self._kernel is None:
            with trace.span("compute.pack"):
                trace.count("compute.packs", 1)
                self._kernel = (
                    KernelWeights(self.w.to(torch.float32), self.occ),
                    KernelWeights((self.w != 0).to(torch.int8), self.occ))
        return self._kernel


def _fc_weight_blocks(layer, bk: int = KERNEL_TILE,
                      bn: int = KERNEL_TILE) -> _WeightBlocks:
    """The fc layer's structure at (bk, bn) tiles; at the default 128, kernel
    mode's for every option set (its occupancy is the weights' own)."""
    return derived_from_weights(
        layer, f"_fc_weight_blocks_{bk}x{bn}",
        lambda l: _WeightBlocks(l.weights, bk, bn))


def _conv_weight_blocks(layer) -> _WeightBlocks:
    """Kernel mode's structure of the conv layer's patch weights, at
    128-wide tiles."""
    return derived_from_weights(
        layer, f"_conv_weight_blocks_{KERNEL_TILE}x{KERNEL_TILE}",
        lambda l: _WeightBlocks(_patch_weights(l)[0], KERNEL_TILE,
                                KERNEL_TILE))


def _im2col(x4: torch.Tensor, kh: int, kw: int, stride: int,
            oh: int, ow: int) -> torch.Tensor:
    """SAME-padded strided im2col: ``(T, cin, h, w) -> (T * oh * ow,
    cin * kh * kw)`` patch rows in (cin, kh, kw) feature order, padded the
    XLA way (``lo = total // 2``) so the windows are exactly the dense
    conv's receptive fields."""
    T, cin, h, w = x4.shape
    pad_h = max(0, (oh - 1) * stride + kh - h)
    pad_w = max(0, (ow - 1) * stride + kw - w)
    x4 = F.pad(x4, (pad_w // 2, pad_w - pad_w // 2,
                    pad_h // 2, pad_h - pad_h // 2))
    win = x4.unfold(2, kh, stride).unfold(3, kw, stride)[:, :, :oh, :ow]
    # (T, cin, oh, ow, kh, kw) -> (T, oh, ow, cin, kh, kw) -> rows
    return win.permute(0, 2, 3, 1, 4, 5).reshape(T * oh * ow, cin * kh * kw)


class EventCompute(LayerCompute):
    """Event-driven synaptic forward: skip all work for event-free inputs.

    ``threshold`` defines an event (``|x| > threshold``).  At 0.0, the
    simulator's wire semantics where any nonzero message is an event,
    every mode equals the dense contraction exactly, since skipped inputs
    contribute exact zeros; above it, gather mode drops sub-threshold
    columns per row tile and kernel mode skips (bm, bk) tiles with no
    entry above it, two different approximations.  ``bm``/``bk``/``bn``
    are kernel mode's tiles.  Its weights are laid out for the CUDA
    kernel's 128-wide tiles once per layer under every option set: their
    occupancy is their own, so zeroing unoccupied (bk, bn) tiles changes
    nothing; other (bm, bk) zero the dead activation tiles first
    (:func:`kernel_operand`).  ``bk``/``bn`` are also gather mode's
    weight tiles, ``gather_bm`` its row tile.  ``delta_mode``
    ``"window"`` reconstructs sigma-delta inputs by temporal tiles of
    ``delta_window`` steps (by default ``bm`` in kernel mode, so quiet
    windows line up with skippable activation tiles, ``max(8,
    gather_bm)`` otherwise); ``"cumsum"`` takes the dense time cumsum.
    ``mode`` picks the kernel path (module docstring).
    """

    name = "event"

    def __init__(self, mode: str = "auto", threshold: float = 0.0,
                 bm: int = 128, bk: int = 128, bn: int = 128,
                 gather_bm: int = 32, delta_mode: str = "window",
                 delta_window: int | None = None):
        if mode not in ("auto", "kernel", "gather"):
            raise ValueError(f"unknown event kernel mode {mode!r}")
        if delta_mode not in ("window", "cumsum"):
            raise ValueError(f"unknown delta mode {delta_mode!r}")
        self.mode = mode
        self.threshold = float(threshold)
        self.bm, self.bk, self.bn = bm, bk, bn
        self.gather_bm = int(gather_bm)
        self.delta_mode = delta_mode
        self.delta_window = delta_window

    def _kernel_mode(self, device: torch.device) -> str:
        if self.mode != "auto":
            return self.mode
        return "kernel" if device.type == "cuda" else "gather"

    def _delta_window_size(self, device: torch.device) -> int:
        """Temporal tile length for windowed delta reconstruction:
        ``delta_window`` when given, else the kernel's time tile ``bm`` in
        kernel mode, else a sublane-aligned multiple of the gather row
        tile."""
        if self.delta_window is not None:
            return int(self.delta_window)
        if self._kernel_mode(device) == "kernel":
            return self.bm
        return max(8, self.gather_bm)

    # ---------------------------------------------------- event contractions
    def _gather_matmul(self, x: torch.Tensor, w: torch.Tensor,
                       bm: int | None = None,
                       wb: "_WeightBlocks | None" = None) -> torch.Tensor:
        """Column-granular event contraction: ``x @ w`` fetching only the
        weight rows of inputs active within each ``bm``-row tile; with
        ``wb``, dead weight rows are dropped from the union and output
        n-blocks whose occupancy is dead for every surviving k-tile skip
        their slice.  Dropped operands are exact zeros."""
        M, K = x.shape
        N = w.shape[1]
        bm = max(1, bm or self.gather_bm)
        mask = x.abs() > self.threshold
        live = mask.any(dim=0)
        if wb is not None:
            live &= wb.live                  # CSR row skipping
        out = torch.zeros((M, N), dtype=torch.float32, device=x.device)
        for i0 in range(0, M, bm):
            i1 = min(i0 + bm, M)
            cols = torch.nonzero(mask[i0:i1].any(dim=0) & live).flatten()
            if cols.numel() == 0:
                continue                     # event-free tile: no fetch
            if wb is not None and wb.occ.shape[1] > 1:
                nb_live = wb.occ[torch.unique(cols // wb.bk)].any(dim=0)
                if not bool(nb_live.all()):  # block-CSR n-tile skipping
                    ncols = torch.nonzero(
                        nb_live.repeat_interleave(wb.bn)[:N]).flatten()
                    out[i0:i1, ncols] = (x[i0:i1, cols]
                                         @ w[cols][:, ncols])
                    continue
            if 2 * cols.numel() >= K:        # near-dense tile
                out[i0:i1] = x[i0:i1] @ w
            else:
                out[i0:i1] = x[i0:i1, cols] @ w[cols]
        return out

    def _operand(self, x):
        """The kernel's float32 operand and threshold for ``x``."""
        return kernel_operand(x.to(torch.float32), self.threshold, self.bm,
                              self.bk)

    def _values(self, x, wb: _WeightBlocks):
        """``x @ w`` in kernel mode, one library call (``wb`` holds ``w``'s
        structures at 128-wide tiles)."""
        x, threshold = self._operand(x)
        return event_matmul_packed(x, wb.kernel_weights()[0], threshold)

    def _pair(self, x, m, wb: _WeightBlocks):
        """(pre, macs) in kernel mode, one library call: both products
        share ``wb``'s occupancy and skip the same weight tiles; the
        counter is the 0/1 event mask ``m != 0`` against the int8 nnz mask
        at threshold 0, exact."""
        x, threshold = self._operand(x)
        return event_matmul_pair_packed(x, m, *wb.kernel_weights(),
                                        threshold)

    # ------------------------------------------------------------ layer kinds
    def fc_forward(self, layer, x_eff, act_mask, msgs_in):
        if self._kernel_mode(x_eff.device) == "kernel":
            pre, macs = self._pair(x_eff, act_mask, _fc_weight_blocks(layer))
        else:
            wb = _fc_weight_blocks(layer, self.bk, self.bn)
            pre = self._gather_matmul(x_eff, layer.weights, wb=wb)
            macs = self._gather_matmul(act_mask, layer.w_mask, wb=wb)
        return pre, macs, _fetches(msgs_in, macs.shape)

    def _conv_gather(self, a4, wf, layer, wlive=None):
        """Channel-compacted gather-mode conv: input channels with no event
        anywhere in the batch are dropped before the im2col copy.  Returns
        the ``(T * oh * ow, cout)`` result and the per-window event row
        sums (taken before any weight-based dropping: the dense-fetch
        counter counts every event in the window)."""
        kh, kw = layer.weights.shape[:2]
        cin = a4.shape[1]
        oh, ow = layer.out_hw
        active_c = a4.abs().amax(dim=(0, 2, 3)) > self.threshold
        k_c = int(active_c.sum())
        if k_c == 0:
            T = a4.shape[0]
            z = torch.zeros((T * oh * ow, wf.shape[1]), dtype=torch.float32,
                            device=a4.device)
            return z, torch.zeros(T * oh * ow, dtype=torch.float32,
                                  device=a4.device)
        if 2 * k_c < cin:
            ch = torch.nonzero(active_c).flatten()
            a4 = a4[:, ch]
            wf = wf.reshape(cin, kh * kw, -1)[ch].reshape(k_c * kh * kw, -1)
            if wlive is not None:
                wlive = wlive.reshape(cin, kh * kw)[ch].reshape(-1)
        pat = _im2col(a4, kh, kw, layer.stride, oh, ow)
        rows = pat.sum(dim=1)
        wb = None
        if wlive is not None and not bool(wlive.all()):
            wb = _WeightBlocks.rows_only(wlive)
        # conv rows are window positions (oh * ow per step): a tile holds
        # at least a whole step's windows
        return self._gather_matmul(pat, wf, bm=max(self.gather_bm, oh * ow),
                                   wb=wb), rows

    def conv_forward(self, layer, x_eff, act_mask, msgs_in):
        """Event-driven conv through the im2col view: ``macs`` sums the
        weight-nnz mask over each window's events and ``fetches_dense``
        counts every event in the window once per output channel."""
        T = x_eff.shape[0]
        kh, kw = layer.weights.shape[:2]
        oh, ow = layer.out_hw
        cout = layer.weights.shape[3]
        x4 = _conv_input(layer, x_eff)
        m4 = _conv_input(layer, act_mask)
        if self._kernel_mode(x_eff.device) == "gather":
            wf, wfm, wlive = _patch_weights(layer)
            pre, _ = self._conv_gather(x4, wf, layer, wlive)
            macs, fetch_rows = self._conv_gather(m4, wfm, layer, wlive)
        else:
            xpat = _im2col(x4, kh, kw, layer.stride, oh, ow)
            mpat = _im2col(m4, kh, kw, layer.stride, oh, ow)
            pre, macs = self._pair(xpat, mpat, _conv_weight_blocks(layer))
            fetch_rows = mpat.sum(dim=1)
        fetches = fetch_rows[:, None].expand(T * oh * ow, cout)
        return (_conv_flat(layer, pre, T), _conv_flat(layer, macs, T),
                _conv_flat(layer, fetches, T))

    def value_forward(self, layer, x_eff: torch.Tensor) -> torch.Tensor:
        """The ``(T, n_out)`` pre-activations alone, no counters: the same
        value contraction as :meth:`forward`'s (the delta path's base
        rows, whose counters nobody reads)."""
        kernel = self._kernel_mode(x_eff.device) == "kernel"
        if layer.kind == "fc":
            if kernel:
                return self._values(x_eff, _fc_weight_blocks(layer))
            return self._gather_matmul(
                x_eff, layer.weights,
                wb=_fc_weight_blocks(layer, self.bk, self.bn))
        kh, kw = layer.weights.shape[:2]
        oh, ow = layer.out_hw
        x4 = _conv_input(layer, x_eff)
        if kernel:
            pre = self._values(_im2col(x4, kh, kw, layer.stride, oh, ow),
                               _conv_weight_blocks(layer))
        else:
            wf, _, wlive = _patch_weights(layer)
            pre, _ = self._conv_gather(x4, wf, layer, wlive)
        return _conv_flat(layer, pre, x_eff.shape[0])

    # --------------------------------------------- temporal-tile delta path
    def delta_forward(self, layer, x_in, in_acc, act_mask, msgs_in):
        """Windowed delta reconstruction: split time into ``window``-step
        tiles and use linearity of the synaptic forward,

            x_eff = repeat(bases, window) + xwin
            pre   = forward(bases) repeated + forward(xwin)

        ``xwin`` is exactly zero through quiet windows, so its event
        matmul skips them; the ``T / window`` base rows pay one small
        value-only contraction (:meth:`value_forward`, no counter
        product).  Counters come from the unchanged ``act_mask`` /
        ``msgs_in`` and stay bit-identical.  ``delta_mode="cumsum"``, and a
        batch no longer than one window, take the dense time cumsum."""
        T = x_in.shape[0]
        window = self._delta_window_size(x_in.device)
        if self.delta_mode != "window" or T <= window:
            return super().delta_forward(layer, x_in, in_acc, act_mask,
                                         msgs_in)
        if self._kernel_mode(x_in.device) == "kernel":
            bases, xwin, new_acc = window_reconstruct(
                x_in.to(torch.float32), in_acc.to(torch.float32),
                window=window)
        else:
            bases, xwin, new_acc = _window_reconstruct_host(x_in, in_acc,
                                                            window)
        pre_w, macs, fetches = self.forward(layer, xwin, act_mask, msgs_in)
        pre_b = self.value_forward(layer, bases)
        pre = pre_w + pre_b.repeat_interleave(window, dim=0)[:T]
        return pre, macs, fetches, new_acc


def _conv_input(layer, a: torch.Tensor) -> torch.Tensor:
    """A ``(T, cin * h * w)`` channel-major flat map as ``(T, cin, h, w)``
    float32."""
    h, w = layer.in_hw
    return a.to(torch.float32).reshape(a.shape[0], layer.weights.shape[2],
                                       h, w)


def _conv_flat(layer, a: torch.Tensor, T: int) -> torch.Tensor:
    """``(T * oh * ow, cout)`` im2col rows -> the channel-major ``(T,
    cout * oh * ow)`` flat map."""
    oh, ow = layer.out_hw
    return a.reshape(T, oh, ow, layer.weights.shape[3]).permute(
        0, 3, 1, 2).reshape(T, -1)


def _window_reconstruct_host(x_in: torch.Tensor, acc: torch.Tensor,
                             window: int):
    """Gather-mode counterpart of :func:`window_reconstruct` (same
    decomposition, sequential float32 sums in the reference's order):
    quiet windows are skipped outright."""
    T, n = x_in.shape
    pt = (-T) % window
    xp = F.pad(x_in.to(torch.float32), (0, 0, 0, pt))
    xw = xp.reshape(-1, window, n)
    ws = xw[:, 0].clone()                      # per-window totals
    for j in range(1, window):
        ws = ws + xw[:, j]
    csum = _seq_cumsum(ws)
    bases = torch.empty_like(csum)
    bases[0] = acc
    bases[1:] = acc[None, :] + csum[:-1]
    new_acc = acc + csum[-1]
    live = torch.nonzero((xw != 0).any(dim=2).any(dim=1)).flatten()
    xwin = torch.zeros_like(xw)
    if live.numel():
        xwin[live] = _seq_cumsum(xw[live].transpose(0, 1)).transpose(0, 1)
    return bases, xwin.reshape(-1, n)[:T], new_acc


# ---------------------------------------------------------------- registry

_REGISTRY: dict[str, type[LayerCompute]] = {
    "dense": DenseCompute,
    "event": EventCompute,
}
_INSTANCES: dict[str, LayerCompute] = {}


def register_compute(name: str, factory: type[LayerCompute]) -> None:
    """Register a backend class under ``name`` (overwrites; the shared
    instance is rebuilt on the next :func:`get_compute`)."""
    _REGISTRY[name] = factory
    _INSTANCES.pop(name, None)


def get_compute(spec: "str | LayerCompute | None" = None) -> LayerCompute:
    """Resolve a ``compute=`` argument: None -> :data:`DEFAULT_COMPUTE`,
    a registered name -> its (shared) instance, an instance -> itself."""
    if spec is None:
        spec = DEFAULT_COMPUTE
    if isinstance(spec, LayerCompute):
        return spec
    if spec not in _REGISTRY:
        raise ValueError(f"unknown compute backend {spec!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    if spec not in _INSTANCES:
        _INSTANCES[spec] = _REGISTRY[spec]()
    return _INSTANCES[spec]
