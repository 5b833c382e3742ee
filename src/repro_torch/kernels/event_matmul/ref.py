"""Plain PyTorch versions of the block-sparse event-driven matmul."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def block_activity_ref(x: torch.Tensor, threshold: float, bm: int,
                       bk: int) -> torch.Tensor:
    """(Mb, Kb) bool: tile has at least one event (|x| > threshold).
    M and K must be multiples of (bm, bk)."""
    M, K = x.shape
    tiles = x.abs().reshape(M // bm, bm, K // bk, bk)
    return tiles.amax(dim=(1, 3)) > threshold


def tf32_rna_ref(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on an int32 view of float32 ``v``: the value
    rounded to TF32's 10 mantissa bits, to nearest with ties away from
    zero -- half a TF32 ulp (0x1000) added to the magnitude's bits, then
    the low 13 bits cleared (sign-magnitude, so the carry rounds away from
    zero for either sign, into the exponent where it must, subnormals
    alike, and a finite value past TF32's largest to inf).  Inf and NaN
    only lose their low 13 bits, as on an H100: a NaN keeps its sign and
    the top of its payload, and one whose payload lies in the low 13 bits
    alone becomes inf.  float32 out, the same shape."""
    u = v.contiguous().view(torch.int32)
    special = (u & 0x7F800000) == 0x7F800000
    return (torch.where(special, u, u + 0x1000) & ~0x1FFF).view(
        torch.float32)


def tf32_split_ref(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3xTF32's halves of float32 ``w`` as the kernel splits its operands:
    ``hi = tf32_rna(w)``, ``lo = tf32_rna(w - hi)``.  ``w - hi`` is exact
    for a finite ``w``, and ``hi + lo`` is within 2^-22 of ``w`` relative
    for a normal one."""
    hi = tf32_rna_ref(w)
    return hi, tf32_rna_ref(w - hi)


def reads_in_place(x: torch.Tensor, rows: int = 64, bk: int = 128) -> bool:
    """Whether the CUDA kernel reads ``x`` (M, K) where it lies: K a
    multiple of the ``bk`` k tile, M of the kernel's ``rows``-row blocks (a
    block reads all of its rows once one is live), the rows packed
    row-major from a 16-byte boundary (``cp.async`` copies 16 bytes).  Else
    the bind copies ``x`` into a zero-padded layout."""
    M, K = x.shape
    return (K % bk == 0 and M % rows == 0 and x.stride(1) == 1
            and x.stride(0) == K and x.data_ptr() % 16 == 0)


class Bound(NamedTuple):
    """What the bind gives the products of one call."""
    active: torch.Tensor                 # (Mb, Kb) bool, the value product's
    operand: torch.Tensor                # x, or its zero-padded (Mp, Kp) copy
    mask: torch.Tensor | None            # int8 m != 0: (M, K) or (Mp, Kp)
    mask_active: torch.Tensor | None     # (Mb, Kb) bool, the counter's
    copies: int                          # operands in a padded layout


def bind_ref(x: torch.Tensor, m: torch.Tensor | None = None,
             threshold: float = 0.0, bm: int = 128, bk: int = 128,
             rows: int = 64) -> Bound:
    """The CUDA bind as plain tensor code: the (bm, bk) activity map of
    ``x`` on its zero-padded grid, a tile live where some |x| > threshold
    (compared in ``x``'s type, float32 for int8) and no entry is NaN;
    the operand the value product reads (:func:`reads_in_place`); and,
    for a counter's event mask ``m``, the int8 operand ``m != 0`` (NaN is
    an event), in place as (M, K) where the shape allows, else padded to
    (Mp, Kp), with its activity map, the OR of its tiles."""
    M, K = x.shape
    mp, kp = -(-M // bm) * bm, -(-K // bk) * bk

    def tiles_any(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(mp // bm, bm, kp // bk, bk).any(dim=3).any(dim=1)

    xp = F.pad(x, (0, kp - K, 0, mp - M))
    a = xp.abs().to(torch.float32)
    thr = torch.tensor(threshold, dtype=x.dtype if x.is_floating_point()
                       else torch.float32).to(torch.float32)
    active = tiles_any(a > thr) & ~tiles_any(a.isnan())
    in_place = reads_in_place(x, rows, bk)
    operand, copies = (x, 0) if in_place else (xp, 1)
    if m is None:
        return Bound(active, operand, None, None, copies)
    e = F.pad((m != 0).to(torch.int8), (0, kp - K, 0, mp - M))
    if K % bk == 0 and M % rows == 0:
        return Bound(active, operand, e[:M], tiles_any(e != 0), copies)
    return Bound(active, operand, e, tiles_any(e != 0), copies + 1)


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
                      *, threshold: float, bm: int, bk: int, bn: int,
                      out_dtype=torch.float32) -> torch.Tensor:
    """2-D (activation x weight tile) sparsity: a (m, n, k) tile product
    contributes iff the activation tile is active AND the weight tile is
    occupied; both failures contribute exact zeros.  Zeroes inactive
    activation tiles and unoccupied weight tiles, then one dense float32
    ``torch.matmul``, cast to ``out_dtype``.  Shapes must be multiples of
    the tiles."""
    active = block_activity_ref(x, threshold, bm, bk)
    amask = active.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    wmask = w_occ.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    x_masked = torch.where(amask, x, 0.0).to(torch.float32)
    w_masked = torch.where(wmask, w, 0.0).to(torch.float32)
    return (x_masked @ w_masked).to(out_dtype)


def zero_dead_tiles_ref(x: torch.Tensor, threshold: float, bm: int,
                        bk: int) -> torch.Tensor:
    """``x`` with its event-free (bm, bk) tiles (all |x| <= threshold; the
    ragged edge tiles padded with zeros for the test) set to zero, same
    shape.  A product of the result at 128-wide tiles and threshold 0 is
    the (bm, bk) product exactly: a dead tile is zero, a live one keeps
    every entry, sub-threshold ones included."""
    M, K = x.shape
    xp = F.pad(x, (0, (-K) % bk, 0, (-M) % bm))
    active = block_activity_ref(xp, threshold, bm, bk)
    keep = active.repeat_interleave(bm, 0).repeat_interleave(bk, 1)[:M, :K]
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def live_lists_ref(active: torch.Tensor, w_occ: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's in-block live lists, built as a block builds its
    own: per (m, n) output tile, the k steps live in ``active`` (Mb, Kb)
    and, when given, in ``w_occ`` (Kb, Nb) (all n share one list without
    it), compacted in ascending k order 32 at a time -- a live k lands at
    the count so far plus the popcount of the live lanes below it (ballot
    and popcount prefix).  Returns ``idx`` (Mb, Nb, Kb) int32 and ``cnt``
    (Mb, Nb) int32, Nb = 1 without ``w_occ``.  The kernel never reads
    past ``cnt``; here the tail repeats the last live index (0 when there
    is none), as the reference's compaction pads it."""
    mb, kb = active.shape
    live = active[:, None, :] if w_occ is None else (
        active[:, None, :] & w_occ.T[None, :, :])
    nb = live.shape[1]
    idx = torch.zeros((mb, nb, kb + 1), dtype=torch.int32,
                      device=active.device)
    cnt = torch.zeros((mb, nb), dtype=torch.int32, device=active.device)
    for base in range(0, kb, 32):
        lanes = live[:, :, base:base + 32].to(torch.int32)   # one ballot
        below = torch.cumsum(lanes, dim=2) - lanes          # popc(bits & lt)
        dest = torch.where(lanes.bool(), cnt[:, :, None] + below, kb)
        ks = torch.arange(base, base + lanes.shape[2], dtype=torch.int32,
                          device=active.device).expand_as(lanes)
        idx.scatter_(2, dest.to(torch.int64), ks)
        cnt += lanes.sum(dim=2, dtype=torch.int32)
    idx = idx[:, :, :kb]
    last = idx.gather(2, (cnt.to(torch.int64) - 1).clamp_min(0)[:, :, None])
    pos = torch.arange(kb, device=active.device)
    return torch.where(pos < cnt[:, :, None], idx, last), cnt


def split_bounds_ref(cnt: torch.Tensor, splits: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The live entries ``[lo, hi)`` of each list that block ``s`` of
    ``splits`` takes: ``lo = s * cnt // splits``, ``hi = (s + 1) * cnt //
    splits``, each of shape ``(splits, *cnt.shape)``."""
    s = torch.arange(splits + 1, device=cnt.device).reshape(
        -1, *([1] * cnt.ndim))
    bounds = (s * cnt.to(torch.int64)[None]) // splits
    return bounds[:-1], bounds[1:]


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
