"""Sparsity-aware training tools (PyTorch port): the regularizers and
magnitude pruning that sparsity-aware training uses, the sigma-delta
threshold calibration, and the trained :class:`SparsityProfile` that
hands the result to pricing and search.  The JAX package's
``repro.sparsity`` names, all of them."""

from repro_torch.sparsity.regularizers import (synops_loss, tl1_regularizer,
                                               activation_density)
from repro_torch.sparsity.pruning import (apply_masks, magnitude_prune_masks,
                                          prune_and_finetune_sweep,
                                          weight_sparsity)
from repro_torch.sparsity.sigma_delta import (calibrate_thresholds,
                                              delta_sparsity,
                                              sigma_delta_densities,
                                              sigma_delta_messages)
from repro_torch.sparsity.profile import SparsityProfile

__all__ = ["synops_loss", "tl1_regularizer", "activation_density",
           "apply_masks", "magnitude_prune_masks",
           "prune_and_finetune_sweep", "weight_sparsity",
           "calibrate_thresholds", "delta_sparsity",
           "sigma_delta_densities", "sigma_delta_messages",
           "SparsityProfile"]
