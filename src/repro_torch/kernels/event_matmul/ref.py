"""Plain PyTorch versions of the block-sparse event-driven matmul."""

from __future__ import annotations

import torch


def block_activity_ref(x: torch.Tensor, threshold: float, bm: int,
                       bk: int) -> torch.Tensor:
    """(Mb, Kb) bool: tile has at least one event (|x| > threshold).
    M and K must be multiples of (bm, bk)."""
    M, K = x.shape
    tiles = x.abs().reshape(M // bm, bm, K // bk, bk)
    return tiles.amax(dim=(1, 3)) > threshold


def event_matmul_ref(x: torch.Tensor, w: torch.Tensor, *, threshold: float,
                     bm: int, bk: int, out_dtype=None) -> torch.Tensor:
    """Zero event-free (bm, bk) activation tiles, then one dense float32
    matmul, cast to ``out_dtype`` (default ``x.dtype``).  The contract is
    block granularity: inactive tiles are exact zeros and active tiles
    contribute fully, sub-threshold entries included.  Shapes must be
    multiples of the tiles."""
    out_dtype = out_dtype or x.dtype
    active = block_activity_ref(x, threshold, bm, bk)
    amask = active.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    x_masked = torch.where(amask, x, torch.zeros((), dtype=x.dtype))
    return (x_masked.to(torch.float32) @ w.to(torch.float32)).to(out_dtype)


def event_matmul2_ref(x: torch.Tensor, w: torch.Tensor, w_occ: torch.Tensor,
                      *, threshold: float, bm: int, bk: int,
                      bn: int) -> torch.Tensor:
    """2-D (activation x weight tile) sparsity: a (m, n, k) tile product
    contributes iff the activation tile is active AND the weight tile is
    occupied; both failures contribute exact zeros.  Zeroes inactive
    activation tiles and unoccupied weight tiles, then one dense float32
    ``torch.matmul``.  Shapes must be multiples of the tiles."""
    active = block_activity_ref(x, threshold, bm, bk)
    amask = active.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    wmask = w_occ.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    x_masked = torch.where(amask, x, 0.0).to(torch.float32)
    w_masked = torch.where(wmask, w, 0.0).to(torch.float32)
    return x_masked @ w_masked


def event_stats_ref(x: torch.Tensor, threshold: float, bm: int,
                    bk: int) -> dict:
    """Block-level event statistics (active tiles = weight-tile fetches),
    as 0-d tensors."""
    act = block_activity_ref(x, threshold, bm, bk)
    total = act.numel()
    active = act.sum()
    return {
        "active_blocks": active,
        "total_blocks": total,
        "block_density": active / total,
        "element_density": (x.abs() > threshold).to(torch.float32).mean(),
        "skipped_weight_bytes_frac": 1.0 - active / total,
    }
