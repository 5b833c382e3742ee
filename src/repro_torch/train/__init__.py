"""Training (PyTorch port): the LM trainer (:mod:`repro_torch.train.loop`
with :mod:`.step`, :mod:`.optim` and :mod:`.schedules`), the floorline-
guided sparsity-aware trainer (:mod:`repro_torch.train.sparse`) that
closes the paper's iso-accuracy loop, their synthetic data
(:mod:`repro_torch.train.data`) and the checkpoint layout they share with
the search (:mod:`repro_torch.train.checkpoint`)."""

from repro_torch.train.loop import StragglerMonitor, Trainer, TrainerConfig
from repro_torch.train.optim import Optimizer, adafactor, adamw, for_arch
from repro_torch.train.sparse import (SparseTrainConfig, SparseTrainer,
                                      deploy_mlp, mlp_fwd, mlp_init)
from repro_torch.train.step import init_state, make_train_step

__all__ = ["Optimizer", "SparseTrainConfig", "SparseTrainer",
           "StragglerMonitor", "Trainer", "TrainerConfig", "adafactor",
           "adamw", "deploy_mlp", "for_arch", "init_state",
           "make_train_step", "mlp_fwd", "mlp_init"]
