"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each kernel sits in a ``<name>/ops.py`` wrapper beside a plain PyTorch
version of the same function in ``<name>/ref.py``.  A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the kernel
(built on first use by :mod:`repro_torch.kernels.build`) or raises.  Each
wrapper counts its launches in a plain integer attribute, ``launches``.

The public names are the JAX package's: the block-sparse event-driven
matmul (``event_matmul``, ``event_matmul_pair`` and their tile
bookkeeping) and the sigma-delta encoder and windowed reconstruction.
The ssm state neurons' scan, which has no counterpart there, is
imported from its own module (``neuron_scan.ops.ssm_scan``).
"""

from repro_torch.kernels.event_matmul.ops import (block_activity,
                                                  event_matmul,
                                                  event_matmul_pair,
                                                  pad_compact,
                                                  weight_block_occupancy)
from repro_torch.kernels.sigma_delta.ops import (sigma_delta_encode,
                                                 window_reconstruct)

__all__ = ["event_matmul", "event_matmul_pair", "block_activity",
           "pad_compact", "weight_block_occupancy", "sigma_delta_encode",
           "window_reconstruct"]
