"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each kernel sits in a ``<name>/ops.py`` wrapper beside a plain PyTorch
version of the same function in ``<name>/ref.py``.  A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the kernel
(built on first use by :mod:`repro_torch.kernels.build`) or raises.  Each
wrapper counts its launches in a plain integer attribute, ``launches``.
"""
