"""Training (PyTorch port): the floorline-guided sparsity-aware trainer
(:mod:`repro_torch.train.sparse`) that closes the paper's iso-accuracy
loop, its synthetic data (:mod:`repro_torch.train.data`) and the
checkpoint layout it shares with the search
(:mod:`repro_torch.train.checkpoint`).  The JAX package's distributed LM
trainer (``repro.train.loop``) is not ported yet."""

from repro_torch.train.sparse import (SparseTrainConfig, SparseTrainer,
                                      deploy_mlp, mlp_fwd, mlp_init)

__all__ = ["SparseTrainConfig", "SparseTrainer", "deploy_mlp", "mlp_fwd",
           "mlp_init"]
