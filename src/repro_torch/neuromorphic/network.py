"""Network abstraction executed by the neuromorphic simulator (PyTorch).

A :class:`SimNetwork` is a feed-forward stack of :class:`SimLayer` s.  Each
layer holds its synaptic weights (and optional bias / message gate) as
tensors on one device, its neuron model (ReLU / IF-spiking / sigma-delta
ReLU / SSM state) and its weight format.

Two execution engines produce identical event counts:

* **step-major** (``step`` / ``run``): one timestep at a time, layer by
  layer, each step the batched one at T = 1 with state and accumulators
  carried across calls — kept for parity checking.
* **layer-major, time-batched** (``step_batch`` / ``run_batch``): for each
  layer in order, the full ``(T, n_in)`` message matrix is consumed at
  once.  Exact for feed-forward stacks: within a timestep messages flow
  strictly downstream, and stateful neurons carry state only along time
  within one layer: the ``ssm`` state neurons run one scan over T (a
  kernel on the card), the others a Python loop over T of vectorised
  tensor ops on the device.

The per-layer synaptic forward (pre-activations plus the exact MAC / fetch
counter maps) is delegated to a :class:`repro_torch.neuromorphic.compute.
LayerCompute` backend (``compute=``): ``"dense"`` (``torch.matmul`` /
``F.conv2d``) or ``"event"`` (the event-driven path whose kernel mode runs
the hand-written CUDA kernels).  After it one neuron epilogue
(:func:`repro_torch.kernels.neuron_epilogue.ops.neuron_epilogue`, one
kernel launch on the card) applies the bias, a stateless neuron and the
message gate and writes the counter maps; its 0/1 message map and counts
are the next layer's wire events (:class:`Wire`), handed on by
``run_batch`` and ``step`` instead of recomputed.

Every float op that decides a message (neuron recurrences, the sigma-delta
quantiser, the delta accumulator) keeps the float32 operation order of the
JAX package's NumPy code, so counters are bit-identical to it wherever the
pre-activations are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import resolve_device
from repro_torch.kernels.neuron_epilogue.ops import neuron_epilogue
from repro_torch.kernels.neuron_epilogue.ref import (FORCE_ACTIVE, IDENTITY,
                                                     RELU)
from repro_torch.kernels.neuron_scan.ops import ssm_scan
from repro_torch.neuromorphic import compute as _compute


@dataclasses.dataclass
class CounterMaps:
    """Exact per-timestep event counts for one layer.

    Per-neuron maps are flattened in *partition order* (channel-major for
    conv layers) so contiguous core ranges are meaningful.
    """

    msgs_in: torch.Tensor          # 0-d float64: input messages this step
    macs: torch.Tensor             # (n,) nnz multiply-accumulates per neuron
    fetches_dense: torch.Tensor    # (n,) dense-format weight fetches
    msgs_out: torch.Tensor         # (n,) 0/1 message emitted per neuron
    acts_evented: torch.Tensor     # (n,) 0/1 neuron received >= 1 synop


@dataclasses.dataclass
class BatchCounters:
    """Exact event counts for one layer over ALL timesteps (time-major):
    per-neuron maps are ``(T, n_neurons)`` float32 tensors in partition
    order; ``msgs_in`` is ``(T,)`` float64."""

    msgs_in: torch.Tensor
    macs: torch.Tensor
    fetches_dense: torch.Tensor
    msgs_out: torch.Tensor
    acts_evented: torch.Tensor

    def step_view(self, t: int) -> CounterMaps:
        """Per-step view, for parity checks against the step-major engine."""
        return CounterMaps(
            msgs_in=self.msgs_in[t], macs=self.macs[t],
            fetches_dense=self.fetches_dense[t], msgs_out=self.msgs_out[t],
            acts_evented=self.acts_evented[t])


class Wire(NamedTuple):
    """The events one layer puts on the wire to the next, from its neuron
    epilogue: the 0/1 float32 ``mask`` (``y_msgs != 0``; also the layer's
    kept ``msgs_out`` counter, so nothing may write into it) and its
    per-step counts, float32 (``counts``, the compute backends'
    ``msgs_in``) and float64 (``counts64``, the next layer's counter)."""

    mask: torch.Tensor
    counts: torch.Tensor
    counts64: torch.Tensor


@dataclasses.dataclass
class SimLayer:
    """One layer mapped onto one-or-more neurocores."""

    name: str
    kind: str                              # 'fc' | 'conv'
    weights: torch.Tensor                  # fc: (fanin, nout); conv: HWIO
    bias: torch.Tensor | None = None
    neuron_model: str = "relu"             # 'relu' | 'if' | 'sd_relu' | 'ssm'
    weight_format: str | None = None       # None -> platform default
    msg_gate: torch.Tensor | None = None   # 0/1 per neuron
    threshold: float = 0.0                 # IF spike / sigma-delta threshold
    decay: float = 0.9                     # SSM state decay (diag A)
    stride: int = 1                        # conv only
    in_hw: tuple[int, int] | None = None   # conv only: input spatial dims
    force_active: bool = False             # characterization: all emit
    sends_deltas: bool = False             # sigma-delta layers emit deltas

    # ------------------------------------------------------------------ sizes
    @property
    def device(self) -> torch.device:
        return self.weights.device

    @property
    def n_neurons(self) -> int:
        if self.kind == "fc":
            return int(self.weights.shape[1])
        cout = self.weights.shape[3]
        oh, ow = self.out_hw
        return int(cout * oh * ow)

    @property
    def out_hw(self) -> tuple[int, int]:
        assert self.kind == "conv" and self.in_hw is not None
        h, w = self.in_hw
        return (h // self.stride, w // self.stride)   # SAME padding

    @property
    def n_weights(self) -> int:
        return int(np.prod(tuple(self.weights.shape)))

    @property
    def fanin(self) -> int:
        if self.kind == "fc":
            return int(self.weights.shape[0])
        kh, kw, cin, _ = self.weights.shape
        return int(kh * kw * cin)

    def weights_per_core(self, n_cores: int) -> int:
        """Synaptic memory words needed per core under an n_cores split
        (fc: neuron ranges; conv: output-channel ranges)."""
        if self.kind == "fc":
            per = -(-int(self.weights.shape[1]) // n_cores)
            return int(self.weights.shape[0] * per)
        kh, kw, cin, cout = self.weights.shape
        per = -(-int(cout) // n_cores)
        return int(kh * kw * cin * per)

    def to(self, device: "str | torch.device") -> "SimLayer":
        """A copy of the layer with every tensor on ``device``."""
        dev = resolve_device(device)
        move = lambda t: None if t is None else t.to(dev)
        return dataclasses.replace(self, weights=move(self.weights),
                                   bias=move(self.bias),
                                   msg_gate=move(self.msg_gate))

    # --------------------------------------------- cached derived weight data
    # Keyed on the identity of the weights tensor, so rebinding
    # ``layer.weights`` invalidates every derived structure.

    @property
    def w_mask(self) -> torch.Tensor:
        """0/1 float32 mask of nonzero weights (fc MAC counting)."""
        return _compute.derived_from_weights(
            self, "_w_mask", lambda l: (l.weights != 0).to(torch.float32))

    @property
    def w_nnz(self) -> int:
        """Number of nonzero synaptic weights."""
        return _compute.derived_from_weights(
            self, "_w_nnz", lambda l: int((l.weights != 0).sum()))

    @property
    def _conv_kernels(self) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """OIHW conv kernels for ``F.conv2d``: (weights, nnz mask, ones)."""
        def build(l):
            w = l.weights.permute(3, 2, 0, 1).contiguous()
            return w, (w != 0).to(torch.float32), torch.ones_like(w)
        return _compute.derived_from_weights(self, "_conv_kernels_cache",
                                             build)

    def init_state(self) -> dict[str, torch.Tensor]:
        n, dev = self.n_neurons, self.device
        st: dict[str, Any] = {}
        if self.neuron_model == "if":
            st["v"] = torch.zeros(n, dtype=torch.float32, device=dev)
        elif self.neuron_model == "sd_relu":
            st["y_sent"] = torch.zeros(n, dtype=torch.float32, device=dev)
        elif self.neuron_model == "ssm":
            st["x"] = torch.zeros(n, dtype=torch.float32, device=dev)
        return st

    # ------------------------------------------------------------------ step
    def step(self, x_in: torch.Tensor, state: dict,
             in_acc: torch.Tensor | None, *, compute=None
             ) -> tuple[torch.Tensor, dict, CounterMaps,
                        torch.Tensor | None]:
        """One timestep: consume input messages ``x_in`` (n_in,), produce
        output messages, update neuron state, and count events exactly.
        ``in_acc`` reconstructs the upstream activation when the upstream
        layer sends deltas.  :meth:`step_batch` at T = 1."""
        y_msgs, state, counters, in_acc = self.step_batch(
            x_in[None], state, in_acc, compute=compute)
        return y_msgs[0], state, counters.step_view(0), in_acc

    # ------------------------------------------------------- batched step
    def step_batch(self, x_in: torch.Tensor, state: dict,
                   in_acc: torch.Tensor | None, *, compute=None
                   ) -> tuple[torch.Tensor, dict, BatchCounters,
                              torch.Tensor | None]:
        """All T timesteps at once: consume the ``(T, n_in)`` message
        matrix, produce ``(T, n)`` output messages, and count events
        exactly.  Equivalent to T calls of :meth:`step` (bit-identical
        counters; the delta accumulator matches bit for bit when it starts
        at zero, which :meth:`SimNetwork.init_accs` guarantees)."""
        return self._step_batch(x_in, state, in_acc, compute=compute)[:4]

    def _step_batch(self, x_in: torch.Tensor, state: dict,
                    in_acc: torch.Tensor | None, *, compute=None,
                    wire: Wire | None = None):
        """:meth:`step_batch`, taking the input's events from ``wire`` (the
        previous layer's output :class:`Wire`, exact: ``x_in`` is that
        layer's ``y_msgs``) instead of recomputing them, and returning
        this layer's own :class:`Wire` as a fifth element.  After the
        synaptic forward, one :func:`neuron_epilogue` (one kernel launch on
        the card) applies the bias, a stateless neuron and the gate and
        writes every counter map; stateful neurons run first and the
        epilogue takes their messages as they are."""
        with trace.span("network.layer", layer=self.name):
            cc = _compute.get_compute(compute)
            x_in = x_in.to(torch.float32)
            if x_in.ndim != 2:
                raise ValueError(
                    f"step_batch needs (T, n_in), got {tuple(x_in.shape)}")

            if wire is None:
                act_mask = (x_in != 0).to(torch.float32)  # events on the wire
                msgs_in = act_mask.sum(dim=1)              # (T,)
                msgs_in64 = msgs_in.to(torch.float64)
            else:
                if wire.mask.shape != x_in.shape:
                    raise ValueError(
                        f"a wire of {tuple(wire.mask.shape)} for inputs "
                        f"{tuple(x_in.shape)}")
                act_mask, msgs_in, msgs_in64 = wire
                trace.count("network.wire_handoffs", 1)

            with trace.span("compute.forward"):
                if in_acc is not None:
                    pre, macs, fetches_dense, new_acc = cc.delta_forward(
                        self, x_in, in_acc, act_mask, msgs_in)
                else:
                    new_acc = None
                    pre, macs, fetches_dense = cc.forward(
                        self, x_in, act_mask, msgs_in)

            stateless = self.neuron_model == "relu"
            if self.bias is not None and not stateless:
                pre = pre + self.bias

            with trace.span("network.neuron"):
                if stateless:
                    code = FORCE_ACTIVE if self.force_active else RELU
                    y, bias = pre, self.bias
                else:
                    y, state = self._neuron_batch(pre, state)
                    code, bias = IDENTITY, None
                y_msgs, msgs_out, acts, counts, counts64 = neuron_epilogue(
                    y, macs, bias, self.msg_gate, code)

            counters = BatchCounters(
                msgs_in=msgs_in64, macs=macs, fetches_dense=fetches_dense,
                msgs_out=msgs_out, acts_evented=acts)
            return (y_msgs, state, counters, new_acc,
                    Wire(msgs_out, counts, counts64))

    # ------------------------------------------------------------ neuron fns
    def _neuron_batch(self, pre: torch.Tensor, state: dict
                      ) -> tuple[torch.Tensor, dict]:
        """Stateful neuron update over the whole (T, n) pre-activation
        block (stateless relu runs in the neuron epilogue): ``ssm`` runs
        one scan over all T steps (one kernel launch on the card); ``if``
        and ``sd_relu`` loop over T with every per-step op vectorised
        across the n neurons.  Each keeps the float op order of T
        sequential single-step updates."""
        T = pre.shape[0]
        if self.neuron_model == "if":
            thr = max(self.threshold, 1e-6)
            v = state["v"]
            y = torch.empty_like(pre)
            for t in range(T):
                v = v + pre[t]
                spikes = (v >= thr).to(torch.float32)
                v = v - thr * spikes
                y[t] = spikes
            return y, dict(state, v=v)
        if self.neuron_model == "sd_relu":
            relu = torch.clamp_min(pre, 0.0)
            thr = max(self.threshold, 1e-9)
            # a 0-d tensor divisor: CUDA divides by a host scalar as a
            # multiply by its reciprocal, which is not float32 division
            thr_t = torch.tensor(thr, dtype=torch.float32, device=pre.device)
            y_sent = state["y_sent"]
            y = torch.empty_like(pre)
            for t in range(T):
                delta = relu[t] - y_sent
                q = torch.where(delta.abs() >= thr,
                                torch.round(delta / thr_t) * thr, 0.0)
                y_sent = y_sent + q
                y[t] = q
            return y, dict(state, y_sent=y_sent)
        if self.neuron_model == "ssm":
            y, x = ssm_scan(pre, state["x"], self.decay, self.force_active)
            return y, dict(state, x=x)
        raise ValueError(f"unknown neuron model {self.neuron_model}")


@dataclasses.dataclass
class SimNetwork:
    """Feed-forward stack of SimLayers with per-layer state threading.
    Runs where its layers' tensors live."""

    layers: list[SimLayer]
    in_size: int

    @property
    def device(self) -> torch.device:
        return self.layers[0].device

    def to(self, device: "str | torch.device") -> "SimNetwork":
        return SimNetwork([l.to(device) for l in self.layers], self.in_size)

    def _inputs(self, xs) -> torch.Tensor:
        return torch.as_tensor(xs, dtype=torch.float32, device=self.device)

    def init_states(self) -> list[dict]:
        return [l.init_state() for l in self.layers]

    def init_accs(self) -> list[torch.Tensor | None]:
        """Delta-reconstruction accumulators at each layer boundary: layer
        i needs one iff layer i-1 (or the network input) sends deltas."""
        accs: list[torch.Tensor | None] = []
        prev_sends_deltas = False
        prev_n = self.in_size
        for l in self.layers:
            accs.append(torch.zeros(prev_n, dtype=torch.float32,
                                    device=l.device)
                        if prev_sends_deltas else None)
            prev_sends_deltas = l.sends_deltas or l.neuron_model == "sd_relu"
            prev_n = l.n_neurons
        return accs

    def step(self, x: torch.Tensor, states: list[dict],
             accs: list[torch.Tensor | None], *, compute=None
             ) -> tuple[torch.Tensor, list, list, list[CounterMaps]]:
        cc = _compute.get_compute(compute)
        counters: list[CounterMaps] = []
        new_states, new_accs = [], []
        cur, wire = self._inputs(x)[None], None
        for layer, st, acc in zip(self.layers, states, accs):
            cur, st, cnt, acc, wire = layer._step_batch(
                cur, st, acc, compute=cc, wire=wire)
            counters.append(cnt.step_view(0))
            new_states.append(st)
            new_accs.append(acc)
        return cur[0], new_states, new_accs, counters

    def run(self, xs, *, compute=None
            ) -> tuple[torch.Tensor, list[list[CounterMaps]]]:
        """Step-major reference run: (T, in_size) inputs -> (T, out)
        outputs and per-timestep per-layer counters."""
        cc = _compute.get_compute(compute)
        xs = self._inputs(xs)
        states, accs = self.init_states(), self.init_accs()
        outs, all_counters = [], []
        for t in range(xs.shape[0]):
            y, states, accs, counters = self.step(xs[t], states, accs,
                                                  compute=cc)
            outs.append(y.reshape(-1))
            all_counters.append(counters)
        return torch.stack(outs), all_counters

    def run_batch(self, xs, *, compute=None
                  ) -> tuple[torch.Tensor, list[BatchCounters]]:
        """Layer-major run: (T, in_size) inputs -> (T, out) outputs and one
        :class:`BatchCounters` per layer.  Exactly equivalent to
        :meth:`run` but visits each layer once with the full time batch.
        Each layer after the first takes its input's events from the
        previous layer's :class:`Wire`."""
        with trace.request("network.run_batch"):
            cc = _compute.get_compute(compute)
            states, accs = self.init_states(), self.init_accs()
            cur, wire = self._inputs(xs), None
            T = cur.shape[0]
            all_counters: list[BatchCounters] = []
            for i, layer in enumerate(self.layers):
                cur, states[i], cnt, accs[i], wire = layer._step_batch(
                    cur, states[i], accs[i], compute=cc, wire=wire)
                all_counters.append(cnt)
            return cur.reshape(T, -1), all_counters


# ================================================================ builders
# Same numpy RNG calls, in the same order, as the JAX package's builders, so
# a seed gives bit-identical weights in both packages.

_LAYER_FIELDS = tuple(f.name for f in dataclasses.fields(SimLayer))
_TENSOR_FIELDS = ("weights", "bias", "msg_gate")


def _exact_density_mask(shape: tuple[int, ...], density: float,
                        rng: np.random.Generator) -> np.ndarray:
    """0/1 mask with an exact (rounded) fraction of ones, uniformly placed."""
    n = int(np.prod(shape))
    k = int(round(density * n))
    flat = np.zeros(n, np.float32)
    if k > 0:
        flat[rng.choice(n, size=k, replace=False)] = 1.0
    return flat.reshape(shape)


def network_from_numpy(layers: Sequence[Mapping[str, Any]], in_size: int,
                       device: "str | torch.device" = "cuda") -> SimNetwork:
    """Build a :class:`SimNetwork` from plain per-layer field mappings
    (``SimLayer`` field name -> value; arrays as numpy, conv weights HWIO)
    with every array moved to ``device`` as a tensor."""
    dev = resolve_device(device)
    built = []
    for spec in layers:
        unknown = set(spec) - set(_LAYER_FIELDS)
        if unknown:
            raise ValueError(f"unknown SimLayer fields {sorted(unknown)}")
        kw = dict(spec)
        for f in _TENSOR_FIELDS:
            if kw.get(f) is not None:
                kw[f] = torch.as_tensor(np.asarray(kw[f], np.float32),
                                        device=dev)
        if kw.get("in_hw") is not None:
            kw["in_hw"] = tuple(int(v) for v in kw["in_hw"])
        built.append(SimLayer(**kw))
    return SimNetwork(layers=built, in_size=int(in_size))


def fc_network(sizes: list[int], *, weight_density: float | list[float] = 1.0,
               neuron_model: str = "relu", seed: int = 0,
               weight_format: str | None = None,
               device: "str | torch.device" = "cuda") -> SimNetwork:
    """Random fully-connected network with exact per-layer weight density."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    wd = ([weight_density] * (len(sizes) - 1)
          if np.isscalar(weight_density) else list(weight_density))
    layers = []
    for i in range(len(sizes) - 1):
        w = rng.normal(0, 1.0 / np.sqrt(sizes[i]),
                       (sizes[i], sizes[i + 1])).astype(np.float32)
        w *= _exact_density_mask(w.shape, wd[i], rng)
        layers.append(SimLayer(name=f"fc{i}", kind="fc",
                               weights=torch.from_numpy(w).to(dev),
                               neuron_model=neuron_model,
                               weight_format=weight_format))
    return SimNetwork(layers=layers, in_size=sizes[0])


def programmed_fc_network(sizes: list[int], *, weight_densities: list[float],
                          act_densities: list[float], seed: int = 0,
                          weight_format: str | None = None,
                          neuron_model: str = "relu",
                          device: "str | torch.device" = "cuda"
                          ) -> SimNetwork:
    """Characterization-mode network (§V-A): weight density exact per layer,
    activation (message) density exactly *programmed* via per-neuron
    message gates with all neurons forced active."""
    assert len(weight_densities) == len(sizes) - 1
    assert len(act_densities) == len(sizes) - 1
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    layers = []
    for i in range(len(sizes) - 1):
        w = rng.normal(0, 1.0 / np.sqrt(sizes[i]),
                       (sizes[i], sizes[i + 1])).astype(np.float32)
        w *= _exact_density_mask(w.shape, weight_densities[i], rng)
        gate = _exact_density_mask((sizes[i + 1],), act_densities[i], rng)
        layers.append(SimLayer(name=f"fc{i}", kind="fc",
                               weights=torch.from_numpy(w).to(dev),
                               neuron_model=neuron_model,
                               msg_gate=torch.from_numpy(gate).to(dev),
                               force_active=True, weight_format=weight_format))
    return SimNetwork(layers=layers, in_size=sizes[0])


def make_inputs(n: int, density: float, steps: int, seed: int = 0,
                device: "str | torch.device" = "cuda") -> torch.Tensor:
    """(steps, n) float32 inputs with exact per-step message density: one
    (steps, n) normal sample for the values and one row-wise argsort of
    uniform noise for the masks (each row keeps ``round(density * n)``
    ones, uniformly placed)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    vals = np.abs(rng.normal(1.0, 0.2, (steps, n))).astype(np.float32)
    k = int(round(density * n))
    mask = np.zeros((steps, n), np.float32)
    if k > 0:
        order = rng.random((steps, n)).argsort(axis=1)
        np.put_along_axis(mask, order[:, :k], 1.0, axis=1)
    return torch.from_numpy(vals * mask).to(dev)
