"""Floorline-guided sparsity-aware training (paper §VII-A, closing the loop).

The paper's headline iso-accuracy gains pair *training-time* sparsification
with the mapping optimizer.  :class:`SparseTrainer` is that training half:
a deterministic, checkpointable MLP training loop whose sparsity
regularizers (``tl1_regularizer`` / ``synops_loss``) are weighted per layer
by the floorline model — the deployed workload is priced once, each layer
is classified memory-/compute-/traffic-bound
(:func:`repro_torch.core.guidance.floorline_layer_weights`), and the layers
that actually set the step time get pushed toward sparsity hardest.

Three §VII-A recipes are supported, composably:

* **activation regularization** — ``lam > 0`` with ``reg="tl1"`` (AKD1000)
  or ``reg="synops"`` (Speck), floorline-weighted per layer;
* **magnitude pruning + masked fine-tune** — ``prune_sparsity > 0``: after
  the dense/regularized phase, one-shot
  :func:`~repro_torch.sparsity.pruning.magnitude_prune_masks` then
  ``finetune_steps`` of masked training (S5);
* **sigma-delta threshold calibration** — :meth:`calibrate_sigma_delta`
  solves per-layer thresholds for a target message density (PilotNet).

The product is a :class:`~repro_torch.sparsity.profile.SparsityProfile` —
measured per-layer activation densities + the exact weight masks — which
feeds ``simulate`` / ``simulate_population`` / the evolutionary search in
place of synthetic density schedules.

The JAX package's trainer (``repro.train.sparse``), on torch tensors: the
weights, moments and masks live on the trainer's device, each step's batch
is made on the host with numpy and moved there once, and gradients come
from ``torch.autograd``.  The update keeps the JAX package's expression
order.  Checkpointing uses :mod:`repro_torch.train.checkpoint` in the JAX
package's layout (either package resumes the other's run); training is
bit-identically resumable on one device: the data is deterministic in
(seed, step), the optimizer state and masks live in the checkpoint, and
each step runs the same operations.

One difference: the masks are kept in layer order.  The JAX package takes
them as the leaves of ``{"w0": ..., "w1": ...}``, whose keys sort as
strings, so at 11 or more layers its masks land on the wrong layers
(``w10`` sorts before ``w2``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.sparsity import (SparsityProfile, calibrate_thresholds,
                                  magnitude_prune_masks,
                                  sigma_delta_densities, synops_loss,
                                  tl1_regularizer)
from repro_torch.sparsity.profile import _host
from repro_torch.sparsity.regularizers import _mean
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import SyntheticDenoise, SyntheticImages


# --------------------------------------------------------------- tiny MLP

def mlp_init(key, sizes, device: "str | torch.device" = "cuda"):
    """He-ish dense stack init; one weight matrix per layer, no biases.
    ``key`` is a :func:`repro_torch.core.prng.PRNGKey`; the draws are the
    JAX package's ``jax.random.normal`` ones (within the ulps
    :func:`~repro_torch.core.prng.normal` states)."""
    dev = resolve_device(device)
    ps = []
    for i in range(len(sizes) - 1):
        k1, key = prng.split(key)
        w = prng.normal(k1, (sizes[i], sizes[i + 1]), device=dev)
        ps.append(w / torch.tensor(float(np.float32(np.sqrt(sizes[i]))),
                                   dtype=torch.float32, device=dev))
    return ps


def mlp_fwd(ps, x):
    """(output, hidden relu activations); acts[l] is produced by layer l."""
    acts = []
    h = x
    for i, w in enumerate(ps):
        h = h @ w
        if i < len(ps) - 1:
            h = torch.relu(h)
            acts.append(h)
    return h, acts


def deploy_mlp(ps, *, neuron_model="relu", thresholds=None,
               sends_deltas=False, device=None):
    """Lower trained (masked) weights into a priceable ``SimNetwork`` on
    ``device`` (by default the weights' device when they are tensors, else
    the card)."""
    from repro_torch.neuromorphic.network import SimLayer, SimNetwork
    if device is None:
        device = ps[0].device if isinstance(ps[0], torch.Tensor) else "cuda"
    dev = resolve_device(device)
    layers = []
    for i, w in enumerate(ps):
        last = i == len(ps) - 1
        layers.append(SimLayer(
            name=f"fc{i}", kind="fc",
            weights=torch.as_tensor(_host(w), dtype=torch.float32,
                                    device=dev),
            neuron_model=neuron_model if not last else
            ("sd_relu" if neuron_model == "sd_relu" else "relu"),
            threshold=float(thresholds[i] if thresholds is not None else
                            (1.0 if neuron_model == "if" else 0.0)),
            sends_deltas=sends_deltas and not last))
    return SimNetwork(layers=layers, in_size=int(ps[0].shape[0]))


def params_from_numpy(ps, device: "str | torch.device" = "cuda"
                      ) -> list[torch.Tensor]:
    """A list of arrays (the JAX package's trainer parameters, optimizer
    moments or masks, as numpy) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return [torch.from_numpy(np.array(p, np.float32)).to(dev) for p in ps]


# ------------------------------------------------------------------ config

@dataclasses.dataclass
class SparseTrainConfig:
    """One sparsity-aware training run (all phases share one step counter:
    ``[0, steps)`` dense/regularized, ``[steps, steps + finetune_steps)``
    masked fine-tune after the one-shot prune)."""

    sizes: tuple[int, ...] = (128, 256, 128, 10)
    task: str = "images"            # "images" | "denoise"
    steps: int = 200
    lam: float = 0.0                # regularizer strength (0 = dense)
    reg: str = "tl1"                # "tl1" | "synops"
    prune_sparsity: float = 0.0     # one-shot magnitude-prune target
    finetune_steps: int = 0         # masked fine-tune steps after the prune
    lr: float = 3e-3
    batch: int = 64
    seed: int = 0
    min_prune_size: int = 64
    ckpt_dir: str | None = None
    ckpt_every: int = 0             # 0 = no checkpoints
    ckpt_keep: int = 3

    def __post_init__(self):
        if self.prune_sparsity > 0 and self.finetune_steps < 1:
            raise ValueError("prune_sparsity > 0 needs finetune_steps >= 1 "
                             "(the masks are applied at the prune boundary "
                             "inside the training loop)")

    @property
    def total_steps(self) -> int:
        return self.steps + (self.finetune_steps
                             if self.prune_sparsity > 0 else 0)


class SparseTrainer:
    """Deterministic floorline-guided sparse training loop on ``device``
    (the card unless ``device="cpu"`` is asked for).

    ``layer_weights`` — per-hidden-layer regularizer multipliers (length
    ``len(sizes) - 2``), typically from :meth:`floorline_weights`; ``None``
    trains unguided (uniform weights).
    """

    def __init__(self, cfg: SparseTrainConfig, *, layer_weights=None,
                 device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.task == "images":
            hw = int(round(np.sqrt(cfg.sizes[0] / 2)))
            if hw * hw * 2 != cfg.sizes[0]:
                raise ValueError(f"images task needs sizes[0] = 2*hw^2; "
                                 f"got {cfg.sizes[0]}")
            self.data = SyntheticImages(hw=hw, channels=2,
                                        global_batch=cfg.batch,
                                        seed=cfg.seed)
        elif cfg.task == "denoise":
            self.data = SyntheticDenoise(n_features=cfg.sizes[0],
                                         seq_len=24,
                                         global_batch=max(cfg.batch // 4, 2),
                                         seed=cfg.seed)
        else:
            raise ValueError(f"unknown task {cfg.task!r}")
        n_hidden = len(cfg.sizes) - 2
        self.layer_weights = (None if layer_weights is None else
                              tuple(float(w) for w in layer_weights))
        if self.layer_weights is not None and \
                len(self.layer_weights) != n_hidden:
            raise ValueError(f"layer_weights must have {n_hidden} entries "
                             f"(one per hidden layer); got "
                             f"{len(self.layer_weights)}")
        self.fanouts = [cfg.sizes[i + 2] for i in range(n_hidden)]
        self.params = mlp_init(prng.PRNGKey(cfg.seed), cfg.sizes,
                               device=self.device)
        self.masks = [torch.ones_like(p) for p in self.params]
        self.opt_m = [torch.zeros_like(p) for p in self.params]
        self.opt_v = [torch.zeros_like(p) for p in self.params]
        self.step = 0
        self.losses: list[float] = []

    # ------------------------------------------------------------- batches
    def _host_batch(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        b = self.data.batch(t)
        if self.cfg.task == "images":
            return b["x"].reshape(len(b["y"]), -1), b["y"]
        n = self.cfg.sizes[0]
        return b["noisy"].reshape(-1, n), b["clean"].reshape(-1, n)

    def _batch(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in self._host_batch(t))

    # ---------------------------------------------------------------- loss
    def _loss(self, ps, batch):
        x, y = batch
        out, acts = mlp_fwd(ps, x)
        if self.cfg.task == "images":
            nll = -torch.log_softmax(out, -1)
            task = _mean(nll.gather(1, y.long()[:, None]))
        else:
            d = out - y
            task = _mean(d * d)
        if not self.cfg.lam:
            return task
        if self.cfg.reg == "tl1":
            reg = tl1_regularizer(acts, weights=self.layer_weights)
        elif self.cfg.reg == "synops":
            reg = synops_loss(acts, self.fanouts,
                              weights=self.layer_weights)
        else:
            raise ValueError(f"unknown reg {self.cfg.reg!r}")
        return task + self.cfg.lam * reg

    def _grads(self, pz, batch):
        """(loss, gradients) at the (masked) parameters ``pz``."""
        leaves = [p.detach().requires_grad_(True) for p in pz]
        with torch.enable_grad():
            loss = self._loss(leaves, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    @torch.no_grad()
    def _update(self, ps, m, v, masks, batch):
        pz = [w * k for w, k in zip(ps, masks)]
        l, g = self._grads(pz, batch)
        lr = self.cfg.lr
        m = [0.9 * a + 0.1 * b for a, b in zip(m, g)]
        v = [0.99 * a + 0.01 * b * b for a, b in zip(v, g)]
        ps = [(p - lr * mm / (torch.sqrt(vv) + 1e-8)) * k
              for p, mm, vv, k in zip(pz, m, v, masks)]
        return ps, m, v, l

    # ------------------------------------------------------------ guidance
    def floorline_weights(self, chip, *, probe_steps: int = 4,
                          state_weights=None) -> np.ndarray:
        """Per-hidden-layer regularizer weights from the floorline: deploy
        the CURRENT weights, price a probe batch, classify each layer
        (§VI-A) and weight traffic-/memory-bound layers hardest.  Feed the
        result back via a new trainer's ``layer_weights``."""
        from repro_torch.core.guidance import floorline_layer_weights
        net = self.deploy()
        xs = self._probe_xs(probe_steps)
        w = floorline_layer_weights(net, xs, chip,
                                    state_weights=state_weights)
        return w[:len(self.cfg.sizes) - 2]

    def _probe_xs(self, steps: int) -> np.ndarray:
        """The held-out probe stream (host numpy): the first ``steps`` rows
        of step 10,999's batch, clipped at zero."""
        x, _ = self._host_batch(10_999)
        return np.maximum(np.asarray(x[:steps], np.float32), 0.0)

    # ----------------------------------------------------------- main loop
    def train(self, *, resume: bool = False, stop_after: int | None = None
              ) -> "SparseTrainer":
        """Run (or resume) the full schedule.  ``stop_after`` halts once
        the global step counter reaches it (the kill point of the
        checkpoint-parity contract); call again with ``resume=True`` to
        continue bit-identically."""
        cfg = self.cfg
        if resume:
            if not cfg.ckpt_dir:
                raise ValueError("resume=True needs cfg.ckpt_dir")
            state, step, extra = ckpt_lib.restore(cfg.ckpt_dir,
                                                  self._state())
            self.params, self.opt_m = state["params"], state["m"]
            self.opt_v, self.masks = state["v"], state["masks"]
            self.step = step
            self.losses = [float(l) for l in extra.get("losses", [])]
        while self.step < cfg.total_steps:
            if stop_after is not None and self.step >= stop_after:
                break
            if cfg.prune_sparsity > 0 and self.step == cfg.steps:
                self.masks = magnitude_prune_masks(
                    self.params, cfg.prune_sparsity,
                    min_size=cfg.min_prune_size)
                self.params = [w * k for w, k in
                               zip(self.params, self.masks)]
            self.params, self.opt_m, self.opt_v, l = self._update(
                self.params, self.opt_m, self.opt_v, self.masks,
                self._batch(self.step))
            self.step += 1
            self.losses.append(float(l))
            if (cfg.ckpt_dir and cfg.ckpt_every
                    and self.step % cfg.ckpt_every == 0):
                self._save()
        if cfg.ckpt_dir and cfg.ckpt_every and self.step == cfg.total_steps:
            self._save()
        return self

    def _state(self) -> dict:
        return {"params": self.params, "m": self.opt_m, "v": self.opt_v,
                "masks": self.masks}

    def _save(self):
        ckpt_lib.save(self.cfg.ckpt_dir, self.step, self._state(),
                      extra={"losses": self.losses},
                      keep=self.cfg.ckpt_keep)

    # ------------------------------------------------------------- metrics
    def masked_params(self) -> list[torch.Tensor]:
        """The trained weights times their masks (float32, on the
        trainer's device)."""
        return [(w * k).to(torch.float32)
                for w, k in zip(self.params, self.masks)]

    @torch.no_grad()
    def eval_metrics(self, *, t: int = 10_000) -> dict:
        """Held-out task metric (training never touches step >= 10_000)."""
        x, y = self._batch(t)
        out, acts = mlp_fwd(self.masked_params(), x)
        dens = float(np.mean([int((a > 0).sum()) / a.numel()
                              for a in acts]))
        if self.cfg.task == "images":
            acc = float(_mean((out.argmax(-1) == y.long())
                              .to(torch.float32)))
            return {"acc": acc, "act_density": dens}
        d = out - y
        return {"mse": float(_mean(d * d)), "act_density": dens}

    # ------------------------------------------------------------- profile
    @torch.no_grad()
    def extract_profile(self, *, t: int = 10_000, meta=None
                        ) -> SparsityProfile:
        """Measure the trained sparsity profile on a held-out batch:
        per-layer message densities of the DEPLOYED network (hidden relu
        activations + positive output fraction), exact weight masks, and
        the input stream's density."""
        x, _ = self._batch(t)
        out, acts = mlp_fwd(self.masked_params(), x)
        names = [f"fc{i}" for i in range(len(self.params))]
        return SparsityProfile.from_activations(
            names, acts + [out], masks=self.masks,
            input_density=int((x > 0).sum()) / x.numel(),
            meta={"task": self.cfg.task, "steps": self.step,
                  "lam": self.cfg.lam, "reg": self.cfg.reg,
                  "prune_sparsity": self.cfg.prune_sparsity,
                  **(meta or {})})

    def deploy(self, **kw):
        return deploy_mlp(self.masked_params(), **kw)

    # --------------------------------------------------------- sigma-delta
    @torch.no_grad()
    def calibrate_sigma_delta(self, target_density, *, t: int = 11_000):
        """PilotNet recipe: solve per-layer Σ-Δ thresholds so each hidden
        layer's message density hits ``target_density`` (scalar or
        per-layer), measured on one held-out temporal sequence.  Returns
        ``(profile, net)`` — the profile carries the thresholds and the
        *measured* Σ-Δ densities; ``net`` is the deployed sigma-delta
        network.  The activations run on the device; the calibration is
        the host's float64 bisection."""
        if self.cfg.task != "denoise":
            raise ValueError("sigma-delta calibration needs the temporal "
                             "'denoise' task")
        seq = self.data.batch(t)["noisy"][0]                 # (S, n)
        ps = self.masked_params()
        acts_seq, h = [], torch.from_numpy(seq).to(self.device)
        for w in ps[:-1]:
            h = torch.relu(h @ w)
            acts_seq.append(_host(h))
        n_hidden = len(acts_seq)
        targets = ([float(target_density)] * n_hidden
                   if np.isscalar(target_density) else
                   [float(d) for d in target_density])
        deltas = [np.diff(a, axis=0).reshape(-1) for a in acts_seq]
        thetas = calibrate_thresholds(deltas, [1.0 - d for d in targets])
        dens = sigma_delta_densities(acts_seq, thetas)
        out = _host(h @ ps[-1])
        names = [f"fc{i}" for i in range(len(ps))]
        masks = [_host(m).astype(np.float32) for m in self.masks]
        profile = SparsityProfile(
            layer_names=names,
            act_density=np.asarray(dens + [float(np.mean(out > 0))]),
            weight_density=np.array([float(np.mean(m != 0))
                                     for m in masks]),
            weight_masks=tuple(masks),
            thresholds=tuple(thetas) + (1e-6,),
            input_density=float(np.mean(seq > 0)),
            meta={"task": self.cfg.task, "recipe": "sigma_delta",
                  "target_density": targets})
        net = deploy_mlp(ps, neuron_model="sd_relu",
                         thresholds=list(thetas) + [1e-6],
                         sends_deltas=True)
        return profile, net
