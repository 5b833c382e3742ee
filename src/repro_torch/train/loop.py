"""Training loop (PyTorch port of ``repro.train.loop``): the train step,
checkpoint and restart, straggler detection, fault recovery, and the
optional int8-compressed gradient step, on one card.

Fault model:
  * process crash      -> restart with ``resume``: restore the latest
                          atomic checkpoint and the data iterator's step;
                          the loss curve continues exactly;
  * a step that raises ``RuntimeError`` (the ``fault_hook``, or the step
                          itself) -> restore the latest checkpoint and
                          go on from there.  Every recovery is recorded in
                          ``Trainer.recoveries``, so a caller can require
                          that none happened unscripted: a restore must
                          not hide a fault of the card.  A step that
                          fails again after the restore, before the run
                          has passed it, raises: the fault is not
                          transient (the reference restores forever);
  * straggler steps    -> StragglerMonitor flags steps > k x EWMA.

Checkpoints have the reference's layout (``params``, ``opt``, ``step``,
``err`` with ``compress_grads``; ``data_step`` in ``meta.json``), so a
run checkpointed by either package resumes in the other.  The reference
reshards a checkpoint onto another mesh; the port runs on one device,
and a mesh of more than one device raises.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.models import encdec, lm
from repro_torch.models.encdec import EncDecCfg
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import step as step_lib
from repro_torch.train.optim import Optimizer
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    num_microbatches: int = 1
    resume: bool = False
    compress_grads: bool = False        # int8 + error feedback
    straggler_factor: float = 3.0
    seed: int = 0


class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than factor x EWMA."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.2):
        self.factor, self.alpha = factor, alpha
        self.ewma: Optional[float] = None
        self.events: list[tuple[int, float, float]] = []

    def record(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.events.append((step, dt, self.ewma))
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt)
        return slow


def make_dp_compressed_step(model, optimizer: Optimizer) -> Callable:
    """The train step with int8 error-feedback gradient reduction, for one
    data-parallel replica: the state carries ``err``, and the optimizer
    sees the float32 dequantized mean."""
    params = step_lib.param_tree(model)

    def step(state, batch):
        if state["params"] is not params:
            raise ValueError("state['params'] is not this model's "
                             "param_tree; build it with init_state")
        _, metrics, grads = step_lib.value_and_grad(model, batch)
        g_mean, new_err = collectives.compressed_grad_mean(grads,
                                                           state["err"])
        new_params, new_opt = optimizer.update(
            g_mean, state["opt"], params, state["step"])
        return ({"params": new_params, "opt": new_opt, "err": new_err,
                 "step": state["step"] + 1}, metrics)
    return step


class Trainer:
    """``Trainer(cfg, mesh, optimizer, data, tcfg, device=...)`` trains
    ``cfg`` from ``init_params(cfg, tcfg.seed, device)`` (or resumes).
    ``mesh`` is None or a mesh shape such as the launcher's
    ``--mesh-shape``; more than one device raises.  Runs on the card
    unless ``device="cpu"``."""

    def __init__(self, cfg, mesh, optimizer: Optimizer, data,
                 tcfg: TrainerConfig, *, device: "str | torch.device" =
                 "cuda"):
        if mesh is not None and math.prod(mesh) > 1:
            raise ValueError(f"mesh {tuple(mesh)}: the port trains on one "
                             "device")
        self.cfg, self.opt, self.data, self.tcfg = cfg, optimizer, data, tcfg
        self.device = resolve_device(device)
        self.monitor = StragglerMonitor(tcfg.straggler_factor)
        self.history: list[dict] = []
        self.recoveries: list[tuple[int, str]] = []
        self.fault_hook: Optional[Callable[[int], None]] = None
        self._build()

    def _build(self):
        cfg, tcfg = self.cfg, self.tcfg
        lib = encdec if isinstance(cfg, EncDecCfg) else lm
        self.model = lib.init_params(cfg, tcfg.seed, self.device)
        self.state = step_lib.init_state(self.model, self.opt)
        if tcfg.compress_grads:
            self.state["err"] = collectives.init_error_feedback(
                self.state["params"])
            self.step_fn = make_dp_compressed_step(self.model, self.opt)
        else:
            self.step_fn = step_lib.make_train_step(
                self.model, self.opt,
                num_microbatches=tcfg.num_microbatches)
        start = 0
        self.data_step = 0
        if tcfg.resume and tcfg.ckpt_dir and \
                ckpt_lib.latest_step(tcfg.ckpt_dir) is not None:
            start = self._restore()
            print(f"[trainer] resumed from step {start}")
        self.start_step = start

    def _restore(self) -> int:
        """Load the latest checkpoint into the state's tensors (through
        the host, so the device never holds two copies) -> its step."""
        like = tree_map(lambda t: torch.empty((), dtype=t.dtype), self.state)
        saved, step, extra = ckpt_lib.restore(self.tcfg.ckpt_dir, like)
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), self.state, saved)
        self.data_step = extra.get("data_step", step)
        return step

    def _save(self, step: int):
        ckpt_lib.save(self.tcfg.ckpt_dir, step, self.state,
                      extra={"data_step": self.data_step},
                      keep=self.tcfg.keep)

    def _put_batch(self, batch_np: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch_np.items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> list[dict]:
        tcfg = self.tcfg
        step = int(self.start_step)
        failed_at = None            # the step that failed before a restore
        while step < tcfg.steps:
            try:
                if self.fault_hook:
                    self.fault_hook(step)
                batch = self._put_batch(self.data.batch(self.data_step))
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                self._sync()
                dt = time.perf_counter() - t0
                slow = self.monitor.record(step, dt)
                step += 1
                self.data_step += 1
                if failed_at is not None and step > failed_at:
                    failed_at = None
                if step % tcfg.log_every == 0 or step == tcfg.steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=step, dt=round(dt, 4), straggler=slow)
                    self.history.append(m)
                    print(f"[trainer] step {step} loss {m['loss']:.4f} "
                          f"({dt*1e3:.0f} ms)"
                          + (" STRAGGLER" if slow else ""))
                if tcfg.ckpt_dir and step % tcfg.ckpt_every == 0:
                    self._save(step)
            except RuntimeError as e:
                # restore the last checkpoint and retry from there
                if not (tcfg.ckpt_dir
                        and ckpt_lib.latest_step(tcfg.ckpt_dir) is not None):
                    raise
                if failed_at == step:
                    raise RuntimeError(f"step {step} failed again after a "
                                       f"restore: {e}") from e
                print(f"[trainer] step {step} failed ({e}); restoring")
                failed_at = step
                self.recoveries.append((step, str(e)))
                step = self._restore()
                self.fault_hook = None
        if tcfg.ckpt_dir:
            self._save(step)
        return self.history
