"""Training loop (PyTorch port of ``repro.train.loop``): the train step,
checkpoint and restart, straggler detection, fault recovery, the optional
int8-compressed gradient step, and data parallelism over a process group.

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
  * node-count change  -> elastic: a checkpoint holds the whole state, so
                          it resumes at another data-parallel world size;
  * straggler steps    -> StragglerMonitor flags steps > k x EWMA.

Checkpoints have the reference's layout (``params``, ``opt``, ``step``,
``err`` with ``compress_grads``; ``data_step`` in ``meta.json``), so a
run checkpointed by either package resumes in the other.

Data and tensor parallelism: on a ``(data, model)`` mesh
(``launch.mesh.make_mesh`` over the process group) the ranks of a data
row hold the same parameters and take rows ``[r * B / n, (r + 1) * B /
n)`` of each global batch (``r`` the data coordinate); along the model
axis each rank holds its block of every split leaf
(``sharding.shard_params``, tensor parallelism) and all see the same
rows.  The exact step is
the reference's GSPMD step: the loss and gradients of the global batch
(``step.make_train_step`` with the data group), with MoE experts sharded
over the group (``moe.shard_experts``).  With ``compress_grads`` each rank
takes its local loss and gradients, the gradients meet in the int8
compressed mean and the metrics in a mean (the reference's
``make_dp_compressed_step``).  A fault hook must raise on every rank at
the same step, so that all ranks restore together.  A checkpoint holds
every leaf whole in the reference's layout: split leaves (and their
optimizer state) are gathered, rank 0 writes, and every rank waits for
the write; a restore slices each leaf for the current mesh, so a run
resumes on another ``(data, model)`` shape (elastic).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives, sharding
from repro_torch.launch.mesh import mesh_of
from repro_torch.models import encdec, lm
from repro_torch.models import moe as moe_lib
from repro_torch.models.encdec import EncDecCfg
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import step as step_lib
from repro_torch.train.optim import Optimizer
from repro_torch.tree import tree_leaves, tree_map


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


def make_dp_compressed_step(model, optimizer: Optimizer, group=None
                            ) -> Callable:
    """The train step with int8 error-feedback gradient reduction over the
    data-parallel ``group`` (one replica without): the state carries
    ``err`` (updated in place, leaf by leaf), each replica takes its local
    loss and gradients, the optimizer sees the float32 compressed mean,
    and the metrics are averaged over the group."""
    params = step_lib.param_tree(model)
    if any(tree_leaves(step_lib.expert_sharded(model))):
        raise ValueError("the compressed step runs each replica's local "
                         "math: experts must not be sharded")
    inv_n = 1.0 / collectives.group_size(group)
    kw = step_lib.split_kw(model)

    def mean_of(g, e):
        mean, new_err = collectives.compressed_psum_mean(g, e, group)
        e.copy_(new_err)            # one leaf's new error alive at a time
        return mean

    def step(state, batch):
        if state["params"] is not params:
            raise ValueError("state['params'] is not this model's "
                             "param_tree; build it with init_state")
        _, metrics, grads = step_lib.value_and_grad(model, batch)
        g_mean = tree_map(mean_of, grads, state["err"])
        del grads
        if group is not None:
            metrics = {k: collectives.all_reduce_(v.clone(), group) * inv_n
                       for k, v in metrics.items()}
        new_params, new_opt = optimizer.update(
            g_mean, state["opt"], params, state["step"], **kw)
        return ({"params": new_params, "opt": new_opt, "err": state["err"],
                 "step": state["step"] + 1}, metrics)
    return step


class Trainer:
    """``Trainer(cfg, mesh, optimizer, data, tcfg, device=...)`` trains
    ``cfg`` from ``init_params(cfg, prng.PRNGKey(tcfg.seed), device)``,
    the reference's weights for that seed (or resumes).
    ``mesh`` is None, a ``launch.mesh.Mesh`` or a mesh shape such as the
    launcher's ``--mesh-shape`` (laid out over the process group): a
    ``(data, model)`` mesh trains data- and tensor-parallel (module
    docstring).  Runs on the card unless ``device="cpu"``."""

    def __init__(self, cfg, mesh, optimizer: Optimizer, data,
                 tcfg: TrainerConfig, *, device: "str | torch.device" =
                 "cuda"):
        self.mesh = mesh_of(mesh)
        self.ctx = sharding.make_ctx(self.mesh)
        self.group = self.ctx.dp_group
        self.n_dp = collectives.group_size(self.group)
        self.rank = collectives.group_rank(self.group)
        self.cfg, self.opt, self.data, self.tcfg = cfg, optimizer, data, tcfg
        self.device = resolve_device(device)
        self.monitor = StragglerMonitor(tcfg.straggler_factor)
        self.history: list[dict] = []
        self.recoveries: list[tuple[int, str]] = []
        self.fault_hook: Optional[Callable[[int], None]] = None
        self._build()

    def _build(self):
        cfg, tcfg, group = self.cfg, self.tcfg, self.group
        lib = encdec if isinstance(cfg, EncDecCfg) else lm
        self.model = lib.init_params(cfg, prng.PRNGKey(tcfg.seed),
                                     self.device)
        if dist.is_initialized() and dist.get_world_size() > 1:
            self._check_replicated()
        if self.ctx.tp_group is not None:
            sharding.shard_params(self.model, self.ctx)
        if group is not None and not tcfg.compress_grads:
            moe_lib.shard_experts(self.model, group)
        self.state = step_lib.init_state(self.model, self.opt)
        if tcfg.compress_grads:
            self.state["err"] = collectives.init_error_feedback(
                self.state["params"])
            self.step_fn = make_dp_compressed_step(self.model, self.opt,
                                                   group)
        else:
            self.step_fn = step_lib.make_train_step(
                self.model, self.opt,
                num_microbatches=tcfg.num_microbatches, group=group)
        # each state leaf's splits over ranks (gathered for a checkpoint),
        # None when every rank holds every leaf whole
        splits = step_lib.leaf_splits(self.model)
        self._splits = None
        if step_lib.any_split(splits):
            self._splits = {"params": splits, "step": (),
                            "opt": self.opt.state_shards(
                                self.state["params"], splits)}
            if "err" in self.state:
                self._splits["err"] = splits
        start = 0
        self.data_step = 0
        if tcfg.resume and tcfg.ckpt_dir and \
                ckpt_lib.latest_step(tcfg.ckpt_dir) is not None:
            start = self._restore()
            self._log(f"[trainer] resumed from step {start}")
        self.start_step = start

    def _check_replicated(self):
        """Every rank drew the same parameters (the same seed): the
        float64 sum of every leaf is equal across the world."""
        world = dist.group.WORLD
        sums = torch.stack([p.detach().double().sum()
                            for p in self.model.parameters()])
        hi = collectives.all_reduce_(sums.clone(), world, dist.ReduceOp.MAX)
        lo = collectives.all_reduce_(sums.clone(), world, dist.ReduceOp.MIN)
        if not torch.equal(hi, lo):
            raise RuntimeError("the ranks' initial parameters differ")

    @property
    def lead(self) -> bool:
        """This rank logs and writes checkpoints: the first of its data
        group and of its model group."""
        return self.rank == 0 and self.ctx.tp_rank == 0

    def _log(self, msg: str):
        if self.lead:
            print(msg)

    def _whole_state(self) -> dict:
        """The state with every split leaf gathered (every rank calls
        it)."""
        if self._splits is None:
            return self.state
        return tree_map(sharding.gather_leaf, self.state, self._splits)

    def _restore(self) -> int:
        """Load the latest checkpoint into the state's tensors (through
        the host, so the device never holds two copies; a split leaf
        takes this rank's block) -> its step."""
        like = tree_map(lambda t: torch.empty((), dtype=t.dtype), self.state)
        shardings = (None if self._splits is None else
                     tree_map(lambda _, sp: ("cpu", sp), like, self._splits))
        saved, step, extra = ckpt_lib.restore(self.tcfg.ckpt_dir, like,
                                              shardings=shardings)
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), self.state, saved)
        self.data_step = extra.get("data_step", step)
        return step

    def _save(self, step: int):
        state = self._whole_state()
        if self.lead:
            ckpt_lib.save(self.tcfg.ckpt_dir, step, state,
                          extra={"data_step": self.data_step},
                          keep=self.tcfg.keep)
        if dist.is_initialized() and (self.group is not None
                                      or self.ctx.tp_group is not None):
            dist.barrier()

    def _put_batch(self, batch_np: dict) -> dict:
        """This rank's rows of the global batch on the device."""
        def rows(v):
            if v.shape[0] % self.n_dp:
                raise ValueError(f"a global batch of {v.shape[0]} does not "
                                 f"split over {self.n_dp} ranks")
            b = v.shape[0] // self.n_dp
            return v[self.rank * b:(self.rank + 1) * b]
        return {k: torch.from_numpy(rows(v)).to(self.device)
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
                    self._log(f"[trainer] step {step} loss {m['loss']:.4f} "
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
                self._log(f"[trainer] step {step} failed ({e}); restoring")
                failed_at = step
                self.recoveries.append((step, str(e)))
                step = self._restore()
                self.fault_hook = None
        if tcfg.ckpt_dir:
            self._save(step)
        return self.history
