"""Wrapper for the ssm state neurons' recurrence over all T steps.

:func:`ssm_scan` launches the CUDA kernel (``csrc/neuron_scan.cu``) on
CUDA tensors, one launch for the whole (T, n) block, and runs
:func:`..ref.ssm_scan_ref` on CPU tensors.  The kernel rounds as the
plain loop's separate PyTorch kernels do, so both give the same bits.
"""

from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.kernels import build
from repro_torch.kernels.neuron_scan.ref import ssm_scan_ref


def ssm_scan(pre: torch.Tensor, x0: torch.Tensor, decay: float,
             force_active: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``x[t] = decay * x[t-1] + pre[t]`` from ``x0`` over the (T, n)
    pre-activations ``pre``: returns the (T, n) messages (``|x[t]| + 1``
    when ``force_active``, else ``x[t]``) and the final state; ``x0`` is
    never written.

    CPU tensors run :func:`..ref.ssm_scan_ref`; CUDA tensors (float32,
    ``pre`` with unit column stride) launch the kernel, counted in
    ``ssm_scan.launches``, under the span ``neuron_scan.launch`` with the
    count ``neuron_scan.entries`` (T x n), and return the final state as
    a new tensor, ``x0``'s copy when T = 0.  ``pre`` is read with its row
    stride, so a row slice of a padded product is not copied; ``decay``
    is rounded to float32, as PyTorch's scalar multiply rounds it."""
    if pre.ndim != 2 or tuple(x0.shape) != (pre.shape[1],):
        raise ValueError(f"ssm_scan takes (T, n) and (n,), got "
                         f"{tuple(pre.shape)}, {tuple(x0.shape)}")
    if pre.device != x0.device:
        raise ValueError("operands on different devices")
    if pre.device.type == "cpu":
        return ssm_scan_ref(pre, x0, decay, force_active)
    if pre.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {pre.device}")
    if pre.dtype != torch.float32 or x0.dtype != torch.float32:
        raise TypeError(f"ssm_scan takes float32 operands, got "
                        f"{pre.dtype}, {x0.dtype}")
    if pre.stride(1) != 1 and pre.shape[1] > 1:
        raise ValueError(f"ssm_scan takes pre with unit column stride, got "
                         f"strides {pre.stride()}")
    T, n = pre.shape
    x0 = x0.contiguous()
    y = torch.empty((T, n), dtype=torch.float32, device=pre.device)
    x = torch.empty_like(x0)
    lib = build.load()
    with trace.span("neuron_scan.launch"):
        with torch.cuda.device(pre.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.ssm_scan_launch(pre.data_ptr(), pre.stride(0),
                                      x0.data_ptr(), y.data_ptr(),
                                      x.data_ptr(), T, n, float(decay),
                                      int(bool(force_active)), stream)
        build.check(err, "ssm_scan")
        ssm_scan.launches += 1
        trace.count("neuron_scan.entries", T * n)
    return y, x


ssm_scan.launches = 0
