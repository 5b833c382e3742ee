"""Trained sparsity profiles and sigma-delta threshold calibration (PyTorch
port).  The JAX package's ``sparsity`` also exports the pruning and
regularizer training tools; they belong to the training slice."""

from repro_torch.sparsity.profile import SparsityProfile
from repro_torch.sparsity.sigma_delta import (calibrate_thresholds,
                                              delta_sparsity,
                                              sigma_delta_densities,
                                              sigma_delta_messages)

__all__ = ["calibrate_thresholds", "delta_sparsity",
           "sigma_delta_densities", "sigma_delta_messages",
           "SparsityProfile"]
