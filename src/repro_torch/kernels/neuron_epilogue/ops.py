"""Wrapper for a layer's neuron epilogue: bias, stateless neuron, message
gate and the counter maps of a (T, n) block in one pass.

:func:`neuron_epilogue` launches the CUDA kernel (``csrc/
neuron_epilogue.cu``) on CUDA tensors, one launch a layer, and runs
:func:`..ref.neuron_epilogue_ref` on CPU tensors.  The kernel rounds as
the plain version's separate PyTorch kernels do, so both give the same
bits.
"""

from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.kernels import build
from repro_torch.kernels.neuron_epilogue.ref import (FORCE_ACTIVE, IDENTITY,
                                                     neuron_epilogue_ref)


def _rows(a: torch.Tensor) -> torch.Tensor:
    """``a`` readable row by row with unit column stride: ``a`` itself
    (a row slice of a padded block included), else a contiguous copy."""
    return a if a.stride(1) == 1 or a.shape[1] <= 1 else a.contiguous()


def neuron_epilogue(pre: torch.Tensor, macs: torch.Tensor,
                    bias: torch.Tensor | None, gate: torch.Tensor | None,
                    code: int) -> tuple[torch.Tensor, ...]:
    """Bias, neuron ``code`` (``ref.IDENTITY``, ``RELU`` or
    ``FORCE_ACTIVE``) and message gate on the (T, n) float32 block ``pre``,
    and the counter maps of :func:`..ref.neuron_epilogue_ref`: returns
    ``(y_msgs, msgs_out, acts_evented, counts, counts64)``.

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    counted in ``neuron_epilogue.launches``, under the span
    ``neuron_epilogue.launch``.  ``pre`` and ``macs`` are read with their
    row strides, so a row slice of a padded product is not copied.  While
    a trace records, each call adds T x n to ``neuron_epilogue.entries``.
    ``bias`` and ``gate`` are (n,) vectors, one entry a neuron.
    The identity without bias or gate returns ``pre`` itself as
    ``y_msgs``, as the plain version does."""
    if pre.ndim != 2 or macs.shape != pre.shape:
        raise ValueError(f"neuron_epilogue takes (T, n) pre and macs, got "
                         f"{tuple(pre.shape)}, {tuple(macs.shape)}")
    if not IDENTITY <= code <= FORCE_ACTIVE:
        raise ValueError(f"unknown neuron code {code}")
    T, n = pre.shape
    for name, t in (("bias", bias), ("gate", gate)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"{name} of {tuple(t.shape)} for {n} neurons")
    trace.count("neuron_epilogue.entries", T * n)
    if pre.device.type == "cpu":
        return neuron_epilogue_ref(pre, macs, bias, gate, code)
    if pre.device.type != "cuda":
        raise ValueError(f"neuron_epilogue: unsupported device {pre.device}")
    for name, t in (("pre", pre), ("macs", macs), ("bias", bias),
                    ("gate", gate)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != pre.device:
            raise TypeError(f"neuron_epilogue takes float32 operands on "
                            f"{pre.device}, got {name} {t.dtype} on "
                            f"{t.device}")
    pre, macs = _rows(pre), _rows(macs)
    bias = None if bias is None else bias.contiguous()
    gate = None if gate is None else gate.contiguous()
    dev = pre.device
    y = (pre if code == IDENTITY and bias is None and gate is None
         else torch.empty((T, n), dtype=torch.float32, device=dev))
    msgs = torch.empty((T, n), dtype=torch.float32, device=dev)
    acts = torch.empty((T, n), dtype=torch.float32, device=dev)
    counts = torch.empty(T, dtype=torch.float32, device=dev)
    counts64 = torch.empty(T, dtype=torch.float64, device=dev)
    lib = build.load()
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (pre.data_ptr(), pre.stride(0), macs.data_ptr(), macs.stride(0),
            ptr(bias), ptr(gate), None if y is pre else y.data_ptr(),
            msgs.data_ptr(), acts.data_ptr(), counts.data_ptr(),
            counts64.data_ptr(), T, n, int(code))
    with trace.span("neuron_epilogue.launch"):
        if dev.index == torch.cuda.current_device():
            err = lib.neuron_epilogue_launch(
                *args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(dev):
                err = lib.neuron_epilogue_launch(
                    *args, torch.cuda.current_stream().cuda_stream)
        build.check(err, "neuron_epilogue")
        neuron_epilogue.launches += 1
    return y, msgs, acts, counts, counts64


neuron_epilogue.launches = 0
