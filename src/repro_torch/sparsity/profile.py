"""Trained sparsity profiles — the artifact that closes the paper's loop.

A :class:`SparsityProfile` captures what sparsity-aware training produced:
per-layer activation (message) densities, per-layer weight densities (and
optionally the exact 0/1 weight masks), and — for sigma-delta recipes —
the calibrated per-layer thresholds.  It is the hand-off between training
and the pricing / search side (``simulate``, ``precompute_pricing``,
``simulate_population``, :class:`~repro_torch.core.partitioner.
SimEvaluator` and the evolutionary search): the mapping optimizer prices
the densities a real training run achieved.

Two consumption modes:

* **exact deployment** — the trained ``SimNetwork`` is priced directly; the
  profile records its measured statistics;
* **density injection** — :meth:`SparsityProfile.apply` programs the
  profile's densities onto an arbitrary ``SimNetwork`` (message gates and
  exact weight masks), and ``compile_network(..., act_density=profile)``
  injects them at model-zoo lowering time.  Injection rewrites only the
  *network*, never the pricing math, so every pricing backend prices a
  profiled workload with its usual parity guarantees.

Profiles serialize to one ``.npz`` (arrays plus a JSON header), atomically,
in the JAX package's layout: a profile saved by either package loads in
the other.  The profile itself is host numpy; :meth:`SparsityProfile.apply`
keeps each layer's tensors on the layer's device.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


@dataclasses.dataclass
class SparsityProfile:
    """Per-layer trained sparsity statistics (one entry per network layer).

    ``act_density[l]`` — fraction of layer ``l``'s neurons that emit a
    message per timestep; ``weight_density[l]`` — fraction of nonzero
    weights; ``weight_masks`` — optional exact 0/1 masks (same shapes as
    the trained weight tensors); ``thresholds`` — optional per-layer
    sigma-delta thetas from :func:`repro_torch.sparsity.sigma_delta.
    calibrate_thresholds`; ``input_density`` — message density of the
    input stream; ``meta`` — free-form provenance.
    """

    layer_names: tuple[str, ...]
    act_density: np.ndarray
    weight_density: np.ndarray
    weight_masks: tuple[np.ndarray, ...] | None = None
    thresholds: tuple[float, ...] | None = None
    input_density: float = 1.0
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.layer_names = tuple(self.layer_names)
        self.act_density = np.asarray(self.act_density, np.float64)
        self.weight_density = np.asarray(self.weight_density, np.float64)
        n = len(self.layer_names)
        if self.act_density.shape != (n,) or self.weight_density.shape != (n,):
            raise ValueError(
                f"profile arrays must be ({n},) to match layer_names; got "
                f"act {self.act_density.shape}, w {self.weight_density.shape}")
        if self.weight_masks is not None:
            self.weight_masks = tuple(
                np.asarray(m, np.float32) for m in self.weight_masks)
        if self.thresholds is not None:
            self.thresholds = tuple(float(t) for t in self.thresholds)

    @property
    def n_layers(self) -> int:
        return len(self.layer_names)

    # ------------------------------------------------------------- builders
    @classmethod
    def from_activations(cls, layer_names, acts, *, weights=None,
                         masks=None, thresholds=None, input_density=1.0,
                         thresh=0.0, meta=None) -> "SparsityProfile":
        """Measure a profile from per-layer activation arrays (numpy or
        tensors, any shapes: density is the fraction of entries
        ``> thresh``).  ``weights`` (or ``masks``) give the weight-density
        column; masks are kept as the exact artifact when given."""
        act_d = np.array([float(np.mean(_host(a) > thresh)) for a in acts],
                         np.float64)
        src = masks if masks is not None else weights
        if src is not None:
            w_d = np.array([float(np.mean(_host(w) != 0)) for w in src],
                           np.float64)
        else:
            w_d = np.ones(len(layer_names), np.float64)
        return cls(layer_names=tuple(layer_names), act_density=act_d,
                   weight_density=w_d,
                   weight_masks=None if masks is None
                   else tuple(_host(m) for m in masks),
                   thresholds=thresholds, input_density=float(input_density),
                   meta=dict(meta or {}))

    # --------------------------------------------------------- resampling
    def densities_for(self, n_layers: int) -> np.ndarray:
        """Resample the per-layer activation densities to ``n_layers`` by
        linear interpolation over normalized depth — how a profile trained
        on an L-layer workload programs an M-layer one."""
        if n_layers == self.n_layers:
            return self.act_density.copy()
        if self.n_layers == 1:
            return np.full(n_layers, float(self.act_density[0]))
        src = np.linspace(0.0, 1.0, self.n_layers)
        dst = np.linspace(0.0, 1.0, n_layers)
        return np.interp(dst, src, self.act_density)

    # ---------------------------------------------------------- injection
    def apply(self, net, *, seed: int = 0):
        """Program this profile onto ``net``: per-layer message gates at
        the profile's activation densities (composed with any structural
        gates) and weight masks — the exact trained masks when shapes
        match, an exact-density random mask otherwise.  Returns a new
        ``SimNetwork`` whose tensors stay on each layer's device; ``net``
        is untouched.  The numpy draws are the JAX package's, in its order
        (one ``default_rng(seed * 100003 + i)`` per layer: the weight mask,
        then the gate), so both packages program the same bits."""
        from repro_torch.neuromorphic.network import (SimNetwork,
                                                      _exact_density_mask)
        dens = self.densities_for(len(net.layers))
        layers = []
        for i, lay in enumerate(net.layers):
            rng = np.random.default_rng(seed * 100003 + i)
            dev = lay.device
            w = lay.weights.to(torch.float32)
            shape = tuple(w.shape)
            if (self.weight_masks is not None and i < len(self.weight_masks)
                    and self.weight_masks[i].shape == shape):
                w = w * torch.from_numpy(self.weight_masks[i]).to(dev)
            elif self.weight_density[min(i, self.n_layers - 1)] < 1.0:
                wd = float(self.weight_density[min(i, self.n_layers - 1)])
                w = w * torch.from_numpy(
                    _exact_density_mask(shape, wd, rng)).to(dev)
            gate = None
            if lay.kind == "fc":
                old = lay.msg_gate
                live = (np.nonzero(_host(old))[0] if old is not None
                        else np.arange(lay.n_neurons))
                keep = int(round(float(dens[i]) * live.size))
                gate = np.zeros(lay.n_neurons, np.float32)
                if keep > 0:
                    gate[rng.choice(live, size=keep, replace=False)] = 1.0
                gate = torch.from_numpy(gate).to(dev)
            thr = lay.threshold
            if (self.thresholds is not None and lay.sends_deltas
                    and i < len(self.thresholds)):
                thr = float(self.thresholds[i])
            layers.append(dataclasses.replace(
                lay, weights=w,
                msg_gate=gate if gate is not None else lay.msg_gate,
                threshold=thr))
        return SimNetwork(layers=layers, in_size=net.in_size)

    # -------------------------------------------------------------- persist
    def save(self, path: str) -> str:
        """Atomic single-file ``.npz`` (tmp file, then ``os.replace``)."""
        arrays = {"act_density": self.act_density,
                  "weight_density": self.weight_density}
        if self.weight_masks is not None:
            for i, m in enumerate(self.weight_masks):
                arrays[f"mask_{i}"] = m
        if self.thresholds is not None:
            arrays["thresholds"] = np.asarray(self.thresholds, np.float64)
        header = {"layer_names": list(self.layer_names),
                  "input_density": self.input_density,
                  "n_masks": 0 if self.weight_masks is None
                  else len(self.weight_masks),
                  "has_thresholds": self.thresholds is not None,
                  "meta": self.meta}
        arrays["header"] = np.frombuffer(
            json.dumps(header).encode(), np.uint8)
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "SparsityProfile":
        with np.load(path) as data:
            header = json.loads(bytes(data["header"]).decode())
            masks = None
            if header["n_masks"]:
                masks = tuple(data[f"mask_{i}"]
                              for i in range(header["n_masks"]))
            thresholds = (tuple(float(t) for t in data["thresholds"])
                          if header["has_thresholds"] else None)
            return cls(layer_names=tuple(header["layer_names"]),
                       act_density=data["act_density"],
                       weight_density=data["weight_density"],
                       weight_masks=masks, thresholds=thresholds,
                       input_density=float(header["input_density"]),
                       meta=header.get("meta", {}))


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu").numpy()
    return np.asarray(a)
