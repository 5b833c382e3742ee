"""PyTorch / CUDA port of the neuromorphic-accelerator simulator.

Mirrors the layout and names of the JAX package ``repro`` so each module
has an obvious counterpart.  Per-timestep and per-neuron data live in
tensors on one explicit device; the main-path kernels
(:mod:`repro_torch.kernels`) are hand-written CUDA C++ for Hopper
(``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use.

Entry points run on the card unless the caller passes ``device="cpu"``;
with the default device and no GPU they raise (:func:`device.resolve_device`).
"""
