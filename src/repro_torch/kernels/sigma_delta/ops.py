"""Wrapper for the windowed delta reconstruction of sigma-delta streams.

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
from repro_torch.kernels.sigma_delta.ref import window_cumsum_ref


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
    into the next batch."""
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
