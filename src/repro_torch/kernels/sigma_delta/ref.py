"""Plain PyTorch versions of the sigma-delta encoder and of the windowed
delta reconstruction."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigma_delta_ref(a: torch.Tensor, s: torch.Tensor, *, theta: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sigma-delta encoder in float32: ``delta = a - s``; ``q =
    round(delta / theta) * theta`` where ``|delta| >= theta``, else 0;
    ``s' = s + q``.  Returns ``(q, s')`` cast to a's and s's types (s' is
    the float32 sum, rounded once).  ``theta`` is rounded to float32 and
    held in a 0-d tensor on the operands' device: on CUDA, dividing by a
    host scalar would multiply by its reciprocal instead."""
    a32, s32 = a.to(torch.float32), s.to(torch.float32)
    th = torch.tensor(theta, dtype=torch.float32, device=a.device)
    delta = a32 - s32
    q = torch.where(delta.abs() >= th, torch.round(delta / th) * th, 0.0)
    return q.to(a.dtype), (s32 + q).to(s.dtype)


def window_cumsum_ref(x: torch.Tensor, live: torch.Tensor, *,
                      window: int) -> torch.Tensor:
    """(T, D) -> within-window cumulative sums along time; rows of windows
    whose ``live`` flag is 0 are exact zeros.  T must be a multiple of
    ``window``."""
    T, D = x.shape
    xw = x.to(torch.float32).reshape(T // window, window, D)
    out = torch.where((live != 0)[:, None, None], torch.cumsum(xw, dim=1),
                      0.0)
    return out.reshape(T, D)


def window_reconstruct_ref(x: torch.Tensor, acc: torch.Tensor, *,
                           window: int) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """Decompose the running reconstruction ``x_eff = acc + cumsum(x)``
    into temporal tiles: per-window base vectors (the accumulator at each
    window start) plus within-window cumulative sums, so that

        x_eff[t] == bases[t // window] + xwin[t]

    up to float reassociation.  Returns ``(bases (nw, n), xwin (T, n),
    new_acc (n,))``."""
    T, n = x.shape
    pt = (-T) % window
    xw = F.pad(x.to(torch.float32), (0, 0, 0, pt)).reshape(-1, window, n)
    csum = torch.cumsum(xw.sum(dim=1), dim=0)
    bases = acc[None, :] + torch.cat(
        [torch.zeros((1, n), dtype=csum.dtype, device=csum.device),
         csum[:-1]])
    xwin = torch.cumsum(xw, dim=1).reshape(-1, n)[:T]
    return bases, xwin, acc + csum[-1]
