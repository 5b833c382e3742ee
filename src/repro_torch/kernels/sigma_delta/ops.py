"""Wrappers for the sigma-delta encoder and the windowed delta
reconstruction of sigma-delta streams.

:func:`sigma_delta_encode` launches the fused encoder
(``csrc/sigma_delta.cu``) on CUDA tensors and runs
:func:`..ref.sigma_delta_ref` on CPU tensors.

:func:`window_reconstruct` splits a (T, n) delta batch into ``window``-step
temporal tiles: the per-window bases and the carried accumulator are
plain torch; the within-window cumulative sums come from
:func:`window_cumsum`, which launches the CUDA kernel
(``csrc/window_cumsum.cu``) on CUDA tensors and runs
:func:`..ref.window_cumsum_ref` on CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.sigma_delta.ref import (sigma_delta_ref,
                                                 window_cumsum_ref)

#: Operand types the encoder is compiled for, by its ``bf16`` flag.
_ENCODER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sigma_delta_encode(a: torch.Tensor, s: torch.Tensor, *, theta: float,
                       bm: int = 256, bd: int = 512
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sigma-delta encode activations ``a`` (..., D) against the
    reconstruction state ``s`` (same shape): returns the quantized delta
    messages ``q`` (zero where |a - s| < theta) and the new state
    ``s + q``, in a's and s's types.  ``bm`` and ``bd`` (the TPU kernel's
    tile) are accepted for signature parity and change nothing.

    CPU tensors run :func:`..ref.sigma_delta_ref`; CUDA tensors launch the
    kernel (float32 or bfloat16, one type for both), counted in
    ``sigma_delta_encode.launches``."""
    if theta <= 0:
        raise ValueError("theta must be positive")
    if a.shape != s.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(s.shape)}")
    if a.device != s.device:
        raise ValueError("operands on different devices")
    if a.device.type == "cpu":
        return sigma_delta_ref(a, s, theta=theta)
    if a.device.type != "cuda":
        raise ValueError(f"sigma_delta_encode: unsupported device "
                         f"{a.device}")
    if a.dtype != s.dtype or a.dtype not in _ENCODER_DTYPES:
        raise TypeError(f"sigma_delta_encode takes float32 or bfloat16 "
                        f"operands of one type, got {a.dtype}, {s.dtype}")
    # the kernel moves 16 bytes per access: inputs start on a 16-byte
    # boundary (fresh outputs always do)
    a, s = (t.contiguous() for t in (a, s))
    a, s = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, s))
    q, s_new = torch.empty_like(a), torch.empty_like(s)
    if a.numel() == 0:
        return q, s_new
    lib = build.load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sigma_delta_launch(a.data_ptr(), s.data_ptr(),
                                     q.data_ptr(), s_new.data_ptr(),
                                     a.numel(), float(theta),
                                     _ENCODER_DTYPES[a.dtype], stream)
    build.check(err, "sigma_delta_encode")
    sigma_delta_encode.launches += 1
    return q, s_new


sigma_delta_encode.launches = 0


def window_cumsum(x: torch.Tensor, live: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """(T, D) float32 -> per-window cumulative sums along time, T a
    multiple of ``window``; ``live`` is the (T / window,) int32 flag
    vector (0 -> the window's rows are exact zeros and its input is never
    read).  Counts kernel launches in ``window_cumsum.launches``."""
    T, D = x.shape
    if T % window or tuple(live.shape) != (T // window,):
        raise ValueError(f"window_cumsum: T={T} window={window} "
                         f"live={tuple(live.shape)}")
    if x.dtype != torch.float32 or live.dtype != torch.int32:
        raise TypeError("window_cumsum takes float32 x and int32 live")
    if x.device != live.device:
        raise ValueError("operands on different devices")
    if x.device.type == "cpu":
        return window_cumsum_ref(x, live, window=window)
    if x.device.type != "cuda":
        raise ValueError(f"window_cumsum: unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.window_cumsum_launch(x.data_ptr(), live.data_ptr(),
                                       out.data_ptr(), T // window, D,
                                       window, stream)
    build.check(err, "window_cumsum")
    window_cumsum.launches += 1
    return out


window_cumsum.launches = 0


def window_reconstruct(x: torch.Tensor, acc: torch.Tensor, *, window: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Windowed delta reconstruction, the temporal-tile replacement for a
    dense cumsum over the time axis of a (T, n) sigma-delta stream.

    Returns ``(bases, xwin, new_acc)`` with ``x_eff[t] == bases[t //
    window] + xwin[t]`` (see :func:`..ref.window_reconstruct_ref`): the
    per-window carried accumulators, the within-window cumulative sums
    (exact zeros throughout quiet windows), and the accumulator to carry
    into the next batch.  ``window`` must be a multiple of 8, as the JAX
    package's kernel requires."""
    if window % 8:
        raise ValueError(f"window must be a multiple of 8, got {window}")
    T, n = x.shape
    pt = (-T) % window
    xp = F.pad(x.to(torch.float32), (0, 0, 0, pt))
    xw = xp.reshape(-1, window, n)
    csum = torch.cumsum(xw.sum(dim=1), dim=0)        # per-window totals
    bases = acc[None, :] + torch.cat(
        [torch.zeros((1, n), dtype=csum.dtype, device=csum.device),
         csum[:-1]])
    new_acc = acc + csum[-1]
    live = (xw != 0).any(dim=2).any(dim=1).to(torch.int32)
    xwin = window_cumsum(xp, live, window=window)
    return bases, xwin[:T], new_acc
