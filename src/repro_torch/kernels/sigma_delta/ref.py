"""Plain PyTorch versions of the windowed delta reconstruction."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
