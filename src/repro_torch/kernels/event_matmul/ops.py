"""Wrappers for the block-sparse event-driven matmul: the public
:func:`event_matmul` / :func:`event_matmul_pair` API and the two kernels
behind it.

The tile bookkeeping — padding, the activity map, the weight-tile
occupancy map and the compacted k lists — is plain torch on the operands'
device.  Both kernels are instances of one tile body
(``csrc/event_matmul.cu``).  Without a weight-tile occupancy map the
product goes through the 1-D kernel (one k list per m-block, shared by
every n); with one, through the joint kernel :func:`event_matmul2` (one k
list per (m, n) tile pair).  CUDA tensors launch the kernel or raise; CPU
tensors run the plain versions in :mod:`.ref`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.event_matmul.ref import (block_activity_ref,
                                                  event_matmul2_ref,
                                                  event_matmul_ref)

#: The tile edge the CUDA kernel is compiled for (bm = bk = bn).
KERNEL_TILE = 128


def _pad_to(a: torch.Tensor, mult: tuple[int, int]) -> torch.Tensor:
    """Zero-pad a 2-D tensor up to multiples of ``mult``; contiguous."""
    pm, pn = (-a.shape[0]) % mult[0], (-a.shape[1]) % mult[1]
    if pm or pn:
        return F.pad(a, (0, pn, 0, pm))
    return a.contiguous()


def block_activity(x: torch.Tensor, threshold: float, bm: int = 128,
                   bk: int = 128) -> torch.Tensor:
    """(Mb, Kb) bool activity map of raw or tile-aligned ``x``: the
    (bm, bk) tile holds at least one event (|x| > threshold)."""
    return block_activity_ref(_pad_to(x, (bm, bk)), threshold, bm, bk)


def pad_compact(x: torch.Tensor, threshold: float, bm: int = 128,
                bk: int = 128) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """One pad, one activity map, one compaction: ``(xp, active, idx,
    cnt)`` — the (bm, bk)-aligned operand, its (Mb, Kb) bool activity map
    and the compacted per-m-block active k-tile indices and counts."""
    xp = _pad_to(x, (bm, bk))
    active = block_activity_ref(xp, threshold, bm, bk)
    idx, cnt = _compact_indices(active)
    return xp, active, idx, cnt


def weight_block_occupancy(w: torch.Tensor, bk: int = 128,
                           bn: int = 128) -> torch.Tensor:
    """(Kb, Nb) bool block-CSR occupancy map: the (bk, bn) tile holds >= 1
    nonzero weight (padding tiles are all-zero, hence unoccupied).
    Accepts the weights themselves or a 0/1 mask."""
    wp = _pad_to(w, (bk, bn))
    K, N = wp.shape
    return (wp != 0).reshape(K // bk, bk, N // bn, bn).any(dim=3).any(dim=1)


def _compact_indices(active: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Per row, compact the active column indices to the front: ``idx``
    (rows, Kb) int32 and ``cnt`` (rows,) int32.  Padding entries repeat
    the last active index (0 for an all-inactive row).  Stable cumsum
    compaction: an active column's slot is its running count minus one."""
    rows, kb = active.shape
    cum = torch.cumsum(active.to(torch.int32), dim=1)
    cnt = cum[:, -1].to(torch.int32)
    # inactive columns scatter into an overflow slot that is sliced away
    dest = torch.where(active, cum - 1, kb).to(torch.int64)
    cols = torch.arange(kb, dtype=torch.int32,
                        device=active.device).expand(rows, kb)
    idx = torch.zeros((rows, kb + 1), dtype=torch.int32,
                      device=active.device).scatter(1, dest, cols)[:, :kb]
    last = idx.gather(1, (cnt.to(torch.int64) - 1).clamp_min(0)[:, None])
    pos = torch.arange(kb, device=active.device)[None, :]
    return torch.where(pos < cnt[:, None], idx, last), cnt


def _compact_indices_joint(active: torch.Tensor, w_occ: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Intersect per-m-block activity (Mb, Kb) with weight-tile occupancy
    (Kb, Nb): ``idx`` (Mb, Nb, Kb) int32 compacted k lists per (m, n) tile
    pair and ``cnt`` (Mb, Nb) int32 live counts — a k step survives only
    when the activation tile has an event AND the weight tile a nonzero."""
    mb, kb = active.shape
    kb2, nb = w_occ.shape
    if kb != kb2:
        raise ValueError(f"activity {tuple(active.shape)} and occupancy "
                         f"{tuple(w_occ.shape)} disagree on Kb")
    joint = active[:, None, :] & w_occ.T[None, :, :]      # (Mb, Nb, Kb)
    idx, cnt = _compact_indices(joint.reshape(mb * nb, kb))
    return idx.reshape(mb, nb, kb), cnt.reshape(mb, nb)


def event_matmul2(x: torch.Tensor, w: torch.Tensor, w_occ: torch.Tensor, *,
                  threshold: float = 0.0, bm: int = 128, bk: int = 128,
                  bn: int = 128) -> torch.Tensor:
    """``y = x @ w`` over (bm, bk, bn) tiles, skipping every tile product
    whose activation tile is event-free (all |x| <= threshold) or whose
    weight tile is unoccupied in ``w_occ`` ((Kb, Nb) bool on the padded
    grid).  Skipped products are exact zeros.  Ragged M, K, N are
    zero-padded here and the result cropped to (M, N) float32.

    CPU tensors run :func:`..ref.event_matmul2_ref`; CUDA tensors launch
    the kernel (tiles of 128 only) and count the launch in
    ``event_matmul2.launches``."""
    M, K = x.shape
    K2, N = w.shape
    kb, nb = -(-K // bk), -(-N // bn)
    if K != K2 or tuple(w_occ.shape) != (kb, nb):
        raise ValueError(f"shape mismatch: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} with occupancy "
                         f"{tuple(w_occ.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("event_matmul2 takes float32 operands")
    if not (x.device == w.device == w_occ.device):
        raise ValueError("operands on different devices")
    xp, wp = _pad_to(x, (bm, bk)), _pad_to(w, (bk, bn))
    if x.device.type == "cpu":
        return event_matmul2_ref(xp, wp, w_occ, threshold=threshold, bm=bm,
                                 bk=bk, bn=bn)[:M, :N]
    if x.device.type != "cuda":
        raise ValueError(f"event_matmul2: unsupported device {x.device}")
    if not bm == bk == bn == KERNEL_TILE:
        raise ValueError(f"the CUDA kernel is built for {KERNEL_TILE}-wide "
                         f"tiles, got bm={bm} bk={bk} bn={bn}")
    active = block_activity_ref(xp, threshold, bm, bk)
    # the kernel reads float4s: operands must start on a 16-byte boundary
    xp, wp = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (xp, wp))
    idx, cnt = _compact_indices_joint(active, w_occ.to(torch.bool))
    mb = xp.shape[0] // bm
    out = torch.empty((xp.shape[0], wp.shape[1]), dtype=torch.float32,
                      device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.event_matmul2_launch(
            xp.data_ptr(), wp.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
            out.data_ptr(), mb, nb, kb, xp.shape[1], wp.shape[1], stream)
    build.check(err, "event_matmul2")
    event_matmul2.launches += 1
    return out[:M, :N]


event_matmul2.launches = 0


#: Operand types the 1-D kernel is compiled for, by its ``bf16`` flag.
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _event_matmul_launch(xp: torch.Tensor, w: torch.Tensor,
                         active: torch.Tensor, bm: int,
                         bk: int) -> torch.Tensor:
    """Launch the 1-D kernel on CUDA operands: ``xp`` padded to (bm, bk),
    ``active`` its (Mb, Kb) activity map.  The kernel's tiles are 128 wide,
    so a (bm, bk) activity map is expanded to them (exact: a 128-tile of an
    active (bm, bk) tile is active, of an inactive one all dead).  Returns
    the padded (Mp, Np) product in the operands' type."""
    if bm % KERNEL_TILE or bk % KERNEL_TILE:
        raise ValueError(f"the CUDA kernel takes tiles that are multiples "
                         f"of {KERNEL_TILE}, got bm={bm} bk={bk}")
    if xp.dtype != w.dtype or xp.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"event_matmul takes float32 or bfloat16 operands "
                        f"of one type, got {xp.dtype} @ {w.dtype}")
    wp = _pad_to(w, (bk, KERNEL_TILE))
    active = (active.repeat_interleave(bm // KERNEL_TILE, 0)
              .repeat_interleave(bk // KERNEL_TILE, 1))
    # the kernel reads 4 elements per thread in one load: 16 bytes in
    # float32, 8 in bfloat16, so operands start on a 16-byte boundary
    xp, wp = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (xp, wp))
    idx, cnt = _compact_indices(active)
    mb, kb = active.shape
    nb = wp.shape[1] // KERNEL_TILE
    out = torch.empty((xp.shape[0], wp.shape[1]), dtype=xp.dtype,
                      device=xp.device)
    lib = build.load()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.event_matmul_launch(
            xp.data_ptr(), wp.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
            out.data_ptr(), mb, nb, kb, xp.shape[1], wp.shape[1],
            _KERNEL_DTYPES[xp.dtype], stream)
    build.check(err, "event_matmul")
    event_matmul.launches += 1
    return out


def event_matmul(x: torch.Tensor, w: torch.Tensor,
                 w_occ: torch.Tensor | None = None, *,
                 threshold: float = 0.0, bm: int = 128, bk: int = 128,
                 bn: int = 128) -> torch.Tensor:
    """``y = x @ w`` skipping event-free (bm, bk) activation tiles (all
    |x| <= threshold): their tile products are exact zeros, while an active
    tile contributes fully, sub-threshold entries included.

    With ``w_occ`` (the (Kb, Nb) occupancy from
    :func:`weight_block_occupancy`) the sparsity goes 2-D through
    :func:`event_matmul2` (float32 only).  Without it, CPU tensors run
    :func:`..ref.event_matmul_ref` and CUDA tensors launch the 1-D kernel
    (float32 or bfloat16, float32 accumulation; bm and bk multiples of 128),
    counted in ``event_matmul.launches``.  ``bn`` does not change the
    result.  Returns (M, N) in ``x.dtype``."""
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("operands on different devices")
    if w_occ is not None:
        return event_matmul2(x, w, w_occ, threshold=threshold, bm=bm, bk=bk,
                             bn=bn)
    xp = _pad_to(x, (bm, bk))
    if x.device.type == "cpu":
        return event_matmul_ref(xp, _pad_to(w, (bk, bn)), threshold=threshold,
                                bm=bm, bk=bk)[:M, :N]
    if x.device.type != "cuda":
        raise ValueError(f"event_matmul: unsupported device {x.device}")
    active = block_activity_ref(xp, threshold, bm, bk)
    return _event_matmul_launch(xp, w, active, bm, bk)[:M, :N]


event_matmul.launches = 0


def event_matmul_pair(x: torch.Tensor, m: torch.Tensor, w: torch.Tensor,
                      wm: torch.Tensor, w_occ: torch.Tensor | None = None,
                      *, threshold: float = 0.0, bm: int = 128,
                      bk: int = 128, bn: int = 128
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The simulator's event backend entry point: the value matmul
    ``x @ w`` and the counter matmul ``m @ wm`` (``m`` the 0/1 wire-event
    mask, ``wm`` the nnz mask of ``w``), each skipping its own event-free
    activation tiles.  With ``w_occ`` both also skip the same unoccupied
    weight tiles (:func:`event_matmul2`); without it both are 1-D
    products (:func:`event_matmul`).  Skipped tiles are exact zeros either
    way, which keeps the counter matmul bit-identical to the dense one.
    Returns ``(y, macs)`` in ``x.dtype`` and ``m.dtype``."""
    if m.shape != x.shape or wm.shape != w.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)}/"
                         f"{tuple(m.shape)} @ {tuple(w.shape)}/"
                         f"{tuple(wm.shape)}")
    kw = dict(bm=bm, bk=bk, bn=bn)
    y = event_matmul(x, w, w_occ, threshold=threshold, **kw)
    macs = event_matmul(m, wm, w_occ, threshold=0.0, **kw)
    return y, macs
