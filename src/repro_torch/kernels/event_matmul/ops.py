"""Wrappers for the block-sparse event-driven matmul: the public
:func:`event_matmul` / :func:`event_matmul_pair` API and the two kernels
behind it.

Both kernels (``csrc/event_matmul.cu``) take float32 operands on a
``wgmma`` body (3xTF32 on the weights' TF32 halves, which
:class:`KernelWeights` makes once, 128-row output tiles) and bfloat16 and
int8 0/1-mask operands (exact counts, float32 out) on an ``mma.sync``
body (64-row tiles).  Without a weight-tile occupancy map the product goes
through the 1-D kernel (one k list per m-block, shared by every n); with
one, through the joint kernel :func:`event_matmul2` (one k list per
(m, n) tile pair).  On CUDA every product goes through one library call,
``event_matmul_pair_launch``: a bind kernel takes the activity map (and,
for a layer's value and counter pair, the int8 operand ``m != 0`` and its
map) in one pass, copying an operand to a zero-padded layout only where
the kernel cannot read it in place, then each product runs; each block
of the kernel intersects the activity map with the occupancy and
compacts its own live list.  The host checks shapes and allocates the
outputs and one workspace.  The kernel reads the weights transposed,
(N, K), and zero-padded to 128-tile multiples: :class:`KernelWeights`,
built per call by the public wrappers and once per layer by the event
backend, whose every option set reaches the kernel through
:func:`event_matmul_packed` and :func:`event_matmul_pair_packed` on the
operand :func:`kernel_operand` makes.  CUDA tensors launch the kernel or
raise; CPU tensors run the plain versions in :mod:`.ref`.  The host
padding, activity map and compaction (:func:`pad_compact`,
``_compact_indices*``) serve the CPU versions, the reference's API and
the tests; no CUDA path calls them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels import build
from repro_torch.kernels.event_matmul.ref import (block_activity_ref,
                                                  event_matmul2_ref,
                                                  event_matmul_ref,
                                                  reads_in_place,
                                                  tf32_split_ref,
                                                  zero_dead_tiles_ref)

#: The tile edge of the CUDA kernel's activity map, k steps and output
#: columns (bm = bk = bn).
KERNEL_TILE = 128
#: Output rows per block of the CUDA kernel's ``mma.sync`` body (two per
#: 128-row m-block).
KERNEL_ROWS = 64
#: Most blocks that share one output tile's live list.
MAX_SPLITS = 8
#: Alignment of each part of the library call's workspace (bytes).
WORKSPACE_ALIGN = 256
#: Operand types the kernel is compiled for: its ``kind`` flag and the
#: output type.  int8 operands are 0/1 masks; their products are counts.
KERNEL_KINDS = {torch.float32: (0, torch.float32),
                torch.bfloat16: (1, torch.bfloat16),
                torch.int8: (2, torch.float32)}


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


def _out_dtype(dtype: torch.dtype) -> torch.dtype:
    """Result type of a product of ``dtype`` operands: int8 masks count
    in float32, every other type is kept."""
    return KERNEL_KINDS.get(dtype, (None, dtype))[1]


def _tiles_to_elements(tiles: torch.Tensor, b0: int, b1: int,
                       shape) -> torch.Tensor:
    """A (rows, cols) tile map expanded to the elements of ``shape``."""
    return (tiles.repeat_interleave(b0, 0).repeat_interleave(b1, 1)
            [:shape[0], :shape[1]])


def kernel_operand(x: torch.Tensor, threshold: float, bm: int,
                   bk: int) -> tuple[torch.Tensor, float]:
    """``(x, threshold)`` as the kernel, whose activity tiles are 128
    wide, takes a product over (bm, bk) activation tiles: unchanged at
    128, else ``x`` with its dead (bm, bk) tiles zeroed
    (:func:`..ref.zero_dead_tiles_ref`) and threshold 0 -- the (bm, bk)
    product exactly."""
    if (bm, bk) == (KERNEL_TILE, KERNEL_TILE):
        return x, threshold
    return zero_dead_tiles_ref(x, threshold, bm, bk), 0.0


def kernel_layout(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weights as the kernel reads them: zero-padded to 128-tile
    multiples and transposed, (Np, Kp) contiguous (K-major, the layout of
    the tensor cores' B fragments)."""
    return _pad_to(w, (KERNEL_TILE, KERNEL_TILE)).T.contiguous()


class KernelWeights:
    """One (K, N) weight matrix prepared for the kernel at 128-wide tiles:
    ``wt`` its :func:`kernel_layout` copy -- for float32 that copy's TF32
    halves instead, (2, Np, Kp), ``hi`` then ``lo`` of
    :func:`..ref.tf32_split_ref`: the ``wgmma`` body's B operands, split
    once here rather than on every k step of every product -- and ``occ``
    the (Kb, Nb) weight-tile occupancy as bytes (None: the 1-D kernel, no
    weight skipping), both built only for CUDA weights.  ``w`` and
    ``w_occ`` are kept for the plain version on the CPU."""

    __slots__ = ("w", "w_occ", "wt", "occ", "_occ_rows")

    def __init__(self, w: torch.Tensor, w_occ: torch.Tensor | None = None):
        kb, nb = -(-w.shape[0] // KERNEL_TILE), -(-w.shape[1] // KERNEL_TILE)
        if w_occ is not None and tuple(w_occ.shape) != (kb, nb):
            raise ValueError(f"occupancy {tuple(w_occ.shape)} does not fit "
                             f"weights {tuple(w.shape)}")
        self.w, self.w_occ = w, w_occ
        self.wt = self.occ = self._occ_rows = None
        if w.device.type == "cuda":
            self.wt = kernel_layout(w)
            if w.dtype == torch.float32:
                self.wt = torch.stack(tf32_split_ref(self.wt))
            if w_occ is not None:
                self.occ = w_occ.to(torch.uint8).contiguous()

    def occ_rows(self) -> torch.Tensor:
        """(Kb,) int64 occupied n tiles in each k row of ``occ``, built at
        first use: an (Mb, Kb) activity map times it, summed, is the joint
        kernel's live (m-block, n-tile, k-tile) triples, ``cnt`` of
        :func:`_compact_indices_joint` summed."""
        if self._occ_rows is None:
            self._occ_rows = self.occ.sum(dim=1, dtype=torch.int64)
        return self._occ_rows


def kernel_splits(tiles: int, kb: int, sms: int) -> int:
    """Blocks per output tile: 1 when the ``tiles`` output tiles fill the
    ``sms`` SMs; else enough for about two blocks per SM, at most
    :data:`MAX_SPLITS` and at most half the ``kb`` k tiles, so that each
    block still walks two live tiles on average when all are live."""
    if tiles >= sms or tiles == 0:
        return 1
    return max(1, min(MAX_SPLITS, kb // 2, -(-2 * sms // tiles)))


def wgmma_splits(tiles: int, kb: int, sms: int) -> int:
    """Blocks per 128-row output tile of the ``wgmma`` body, which holds
    an SM alone: 1 when the ``tiles`` fill the ``sms`` SMs; else as many
    as still fit in one wave, at most :data:`MAX_SPLITS` and at most half
    the ``kb`` k tiles."""
    if tiles >= sms or tiles == 0:
        return 1
    return max(1, min(MAX_SPLITS, kb // 2, sms // tiles))


class CallPlan(NamedTuple):
    """How one library call runs: each product's blocks a tile, and the
    workspace's bytes."""
    splits: int
    splits_m: int
    ws_bytes: int


def call_plan(dtype: torch.dtype, M: int, kp: int, np_: int, sms: int, *,
              pair: bool, pad_x: bool, pad_m: bool) -> CallPlan:
    """The plan of a call on (M, kp) operands of ``dtype`` and (np_, kp)
    weights on a card of ``sms`` SMs: the value product's body (float32
    on ``wgmma``, 128-row tiles; bfloat16 and int8 on ``mma.sync``, 64-row
    tiles, as the counter product), each product's splits
    (:func:`wgmma_splits`, :func:`kernel_splits`), and the workspace in
    the order the library carves it -- the activity maps, the padded copy
    of x, the int8 operand, the split partials (one buffer, the larger
    product's)."""
    mp = -(-M // KERNEL_TILE) * KERNEL_TILE
    mb, nb, kb = mp // KERNEL_TILE, np_ // KERNEL_TILE, kp // KERNEL_TILE
    splits64 = kernel_splits(-(-M // KERNEL_ROWS) * nb, kb, sms)
    splits = (wgmma_splits(mb * nb, kb, sms) if dtype == torch.float32
              else splits64)
    splits_m = splits64 if pair else 1
    most = max(splits, splits_m)
    ws_bytes = ((2 if pair else 1) * _carved(mb * kb)
                + (_carved(mp * kp * dtype.itemsize) if pad_x else 0)
                + (_carved((mp if pad_m else M) * kp) if pair else 0)
                + (_carved(most * mp * np_ * 4) if most > 1 else 0))
    return CallPlan(splits, splits_m, ws_bytes)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _carved(nbytes: int) -> int:
    return -(-nbytes // WORKSPACE_ALIGN) * WORKSPACE_ALIGN


def bind_launch(x: torch.Tensor, kw: KernelWeights, threshold: float = 0.0,
                m: torch.Tensor | None = None,
                kw_mask: KernelWeights | None = None):
    """Check CUDA ``x`` against ``kw`` and, for a pair, the float32 wire
    events ``m`` of its shape against the int8 nnz mask ``kw_mask``, and
    allocate one library call: the padded (Mp, Np) products and one
    workspace.  Returns ``(launch, y, macs)`` (``macs`` None without
    ``m``): ``launch()``, called with the device current, runs on the
    current stream the bind kernel, then the value product (the 1-D kernel
    when ``kw.occ`` is None, else the joint one; on the body
    :func:`call_plan` names) and the counter product ``(m != 0) @
    kw_mask`` (the ``mma.sync`` body), and returns the status code; it
    neither checks nor counts.  ``launch.splits``, the value product's
    blocks a tile;
    ``launch.copies``, the operands copied to a zero-padded layout;
    ``launch.maps()``, the products' (Mb, Kb) activity maps in the
    workspace, valid once ``launch()`` has run."""
    if x.dtype not in KERNEL_KINDS or kw.wt is None or (
            kw.wt.dtype != x.dtype):
        raise TypeError(f"the kernel takes float32, bfloat16 or int8 CUDA "
                        f"operands of one type, got {x.dtype} @ "
                        f"{kw.w.dtype}")
    if x.device != kw.wt.device:
        raise ValueError("operands on different devices")
    kind, out_dtype = KERNEL_KINDS[x.dtype]
    M, K = x.shape
    np_, kp = kw.wt.shape[-2:]
    if -(-K // KERNEL_TILE) * KERNEL_TILE != kp:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                         f"{tuple(kw.w.shape)}")
    pad_m = False
    if m is not None:
        if m.shape != x.shape or m.dtype != torch.float32 or (
                m.device != x.device):
            raise ValueError(f"the event mask must be float32 of the "
                             f"operand's shape and device, got {m.dtype} "
                             f"{tuple(m.shape)} on {m.device}")
        if kw_mask.wt is None or kw_mask.wt.dtype != torch.int8 or (
                kw_mask.wt.shape != (np_, kp)):
            raise TypeError("the counter's weights must be an int8 mask "
                            "of the value weights' shape")
        pad_m = bool(K % KERNEL_TILE or M % KERNEL_ROWS)
    mp = -(-M // KERNEL_TILE) * KERNEL_TILE
    mb, nb, kb = mp // KERNEL_TILE, np_ // KERNEL_TILE, kp // KERNEL_TILE
    pad_x = not reads_in_place(x, KERNEL_ROWS, KERNEL_TILE)
    n_maps = 1 if m is None else 2
    splits, splits_m, ws_bytes = call_plan(
        x.dtype, M, kp, np_, _sm_count(x.device.index or 0),
        pair=m is not None, pad_x=pad_x, pad_m=pad_m)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    y = torch.empty((mp, np_), dtype=out_dtype, device=x.device)
    macs = (None if m is None else
            torch.empty((mp, np_), dtype=torch.float32, device=x.device))
    occ = None if kw.occ is None else kw.occ.data_ptr()
    if m is None:
        counter = (None, 0, 0)
        w8 = occ8 = None
    else:
        counter = (m.data_ptr(), m.stride(0), m.stride(1))
        w8 = kw_mask.wt.data_ptr()
        occ8 = None if kw_mask.occ is None else kw_mask.occ.data_ptr()
    args = (x.data_ptr(), x.stride(0), x.stride(1), *counter,
            kw.wt.data_ptr(), occ, w8, occ8, y.data_ptr(),
            None if macs is None else macs.data_ptr(), ws.data_ptr(),
            ws_bytes, M, K, nb, splits, splits_m, kind, threshold,
            int(pad_x), int(pad_m),
            torch.cuda.current_stream(x.device).cuda_stream)
    lib = build.load()

    def launch() -> int:
        return lib.event_matmul_pair_launch(*args)

    def activity_maps() -> list[torch.Tensor]:
        step = _carved(mb * kb)
        return [ws[i * step:i * step + mb * kb].view(mb, kb)
                for i in range(n_maps)]
    launch.splits = splits
    launch.copies = int(pad_x) + int(pad_m)
    launch.maps = activity_maps
    launch.operands = (x, m, kw, kw_mask, ws)   # alive until it is called
    return launch, y, macs


def _launch(x: torch.Tensor, kw: KernelWeights, threshold: float,
            m: torch.Tensor | None = None,
            kw_mask: KernelWeights | None = None):
    """One library call on CUDA ``x`` (:func:`bind_launch`), each product
    counted: ``event_matmul2``'s count for a joint product,
    ``event_matmul``'s for a 1-D one.  While a trace records, each joint
    product's live and total tile triples go to the counts
    ``event_matmul2.live_tiles`` (a copy of its activity map, queued after
    the call that writes it) and ``event_matmul2.tiles``, the operands
    copied to a padded layout to ``event_matmul.padded_copies``.
    Returns the (M, N) product, or with ``m`` the ``(y, macs)`` pair."""
    with trace.span("event_matmul.bind"):
        launch, y, macs = bind_launch(x, kw, threshold, m, kw_mask)
    products = (kw,) if m is None else (kw, kw_mask)
    with trace.span("event_matmul.launch"):
        if x.device.index == torch.cuda.current_device():
            err = launch()
        else:
            with torch.cuda.device(x.device):
                err = launch()
        build.check(err, "event_matmul" if kw.occ is None
                    else "event_matmul2")
        for k in products:
            (event_matmul if k.occ is None else event_matmul2).launches += 1
    if trace.enabled():
        trace.count("event_matmul.padded_copies", launch.copies)
        for k, active in zip(products, launch.maps()):
            if k.occ is not None:
                mb, kb = active.shape
                trace.count("event_matmul2.live_tiles",
                            (active.clone(), k.occ_rows()))
                trace.count("event_matmul2.tiles", mb * k.occ.shape[1] * kb)
    M, N = x.shape[0], kw.w.shape[1]
    if m is None:
        return y[:M, :N]
    return y[:M, :N], macs[:M, :N]


def event_matmul2(x: torch.Tensor, w: torch.Tensor, w_occ: torch.Tensor, *,
                  threshold: float = 0.0, bm: int = 128, bk: int = 128,
                  bn: int = 128) -> torch.Tensor:
    """``y = x @ w`` over (bm, bk, bn) tiles, skipping every tile product
    whose activation tile is event-free (all |x| <= threshold) or whose
    weight tile is unoccupied in ``w_occ`` ((Kb, Nb) bool on the padded
    grid).  Skipped products are exact zeros.  Operands are float32,
    bfloat16 or int8 (0/1 masks), both of one type; ragged M, K, N are
    zero-padded here and the result cropped to (M, N), float32 for
    float32 and int8 operands, bfloat16 for bfloat16.

    CPU tensors run :func:`..ref.event_matmul2_ref`; CUDA tensors launch
    the joint kernel and count the launch in ``event_matmul2.launches``.
    The kernel's tiles are 128 wide: other (bm, bk) first zero the dead
    activation tiles of ``x`` (:func:`..ref.zero_dead_tiles_ref`) and run
    at threshold 0, other (bk, bn) zero the unoccupied weight tiles of
    ``w`` and take their 128-tile occupancy -- both exact."""
    M, K = x.shape
    K2, N = w.shape
    kb, nb = -(-K // bk), -(-N // bn)
    if K != K2 or tuple(w_occ.shape) != (kb, nb):
        raise ValueError(f"shape mismatch: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} with occupancy "
                         f"{tuple(w_occ.shape)}")
    if x.dtype != w.dtype or x.dtype not in KERNEL_KINDS:
        raise TypeError(f"event_matmul2 takes float32, bfloat16 or int8 "
                        f"operands of one type, got {x.dtype} @ {w.dtype}")
    if not (x.device == w.device == w_occ.device):
        raise ValueError("operands on different devices")
    if x.device.type == "cpu":
        return event_matmul2_ref(_pad_to(x, (bm, bk)), _pad_to(w, (bk, bn)),
                                 w_occ, threshold=threshold, bm=bm, bk=bk,
                                 bn=bn, out_dtype=_out_dtype(x.dtype))[:M, :N]
    if x.device.type != "cuda":
        raise ValueError(f"event_matmul2: unsupported device {x.device}")
    w_occ = w_occ.to(torch.bool)
    x, threshold = kernel_operand(x, threshold, bm, bk)
    if (bk, bn) != (KERNEL_TILE, KERNEL_TILE):
        w = torch.where(_tiles_to_elements(w_occ, bk, bn, w.shape), w,
                        torch.zeros((), dtype=w.dtype, device=w.device))
        w_occ = weight_block_occupancy(w)
    return _launch(x, KernelWeights(w, w_occ), threshold)


event_matmul2.launches = 0


def event_matmul(x: torch.Tensor, w: torch.Tensor,
                 w_occ: torch.Tensor | None = None, *,
                 threshold: float = 0.0, bm: int = 128, bk: int = 128,
                 bn: int = 128) -> torch.Tensor:
    """``y = x @ w`` skipping event-free (bm, bk) activation tiles (all
    |x| <= threshold): their tile products are exact zeros, while an active
    tile contributes fully, sub-threshold entries included.

    With ``w_occ`` (the (Kb, Nb) occupancy from
    :func:`weight_block_occupancy`) the sparsity goes 2-D through
    :func:`event_matmul2`.  Without it, CPU tensors run
    :func:`..ref.event_matmul_ref` and CUDA tensors launch the 1-D kernel
    (float32, bfloat16 or int8 0/1 masks; other (bm, bk) than 128 zero
    the dead tiles first), counted in ``event_matmul.launches``.  ``bn``
    does not change the result.  Returns (M, N) in ``x.dtype``, float32
    for int8 masks."""
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
    if x.device.type == "cpu":
        return event_matmul_ref(_pad_to(x, (bm, bk)), _pad_to(w, (bk, bn)),
                                threshold=threshold, bm=bm, bk=bk,
                                out_dtype=_out_dtype(x.dtype))[:M, :N]
    if x.device.type != "cuda":
        raise ValueError(f"event_matmul: unsupported device {x.device}")
    if x.dtype != w.dtype or x.dtype not in KERNEL_KINDS:
        raise TypeError(f"event_matmul takes float32, bfloat16 or int8 "
                        f"operands of one type, got {x.dtype} @ {w.dtype}")
    x, threshold = kernel_operand(x, threshold, bm, bk)
    return _launch(x, KernelWeights(w), threshold)


event_matmul.launches = 0


def event_matmul_packed(x: torch.Tensor, kw: KernelWeights,
                        threshold: float = 0.0) -> torch.Tensor:
    """``x @ w`` at 128-wide tiles for weights already in the kernel's
    layout: the event backend's entry point for a value product alone,
    with one :class:`KernelWeights` per layer (other activation tiles:
    :func:`kernel_operand` first).  The joint kernel when ``kw`` has an
    occupancy map, else the 1-D one; CPU tensors run the same plain
    versions as :func:`event_matmul`."""
    if x.device.type == "cpu":
        return event_matmul(x, kw.w, kw.w_occ, threshold=threshold)
    if x.device.type != "cuda":
        raise ValueError(f"event_matmul: unsupported device {x.device}")
    return _launch(x, kw, threshold)


def event_matmul_pair_packed(x: torch.Tensor, m: torch.Tensor,
                             kw: KernelWeights, kw_mask: KernelWeights,
                             threshold: float = 0.0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's two products in one library call, at 128-wide tiles:
    the values ``x @ w``, an event ``|x| > threshold``, and the counts
    ``(m != 0) @ wm`` at threshold 0, ``m`` the float32 wire events (the
    delta path's ``x`` differs from them) and ``kw_mask`` the int8 nnz
    mask of ``kw``'s weights, both in the kernel's layout.  CPU tensors
    run the plain versions of :func:`event_matmul_packed`.  Returns ``(y,
    macs)``, both float32 for float32 ``x``."""
    if x.device.type == "cpu":
        return (event_matmul(x, kw.w, kw.w_occ, threshold=threshold),
                event_matmul((m != 0).to(torch.int8), kw_mask.w,
                             kw_mask.w_occ))
    if x.device.type != "cuda":
        raise ValueError(f"event_matmul: unsupported device {x.device}")
    return _launch(x, kw, threshold, m, kw_mask)


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
    way, which keeps the counter matmul bit-identical to the dense one:
    float masks go through the float kernel (3xTF32 is exact on 0/1
    values), int8 masks through the int8 one.  Returns ``(y, macs)`` in
    ``x.dtype`` and ``m.dtype`` (float32 for int8 masks)."""
    if m.shape != x.shape or wm.shape != w.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)}/"
                         f"{tuple(m.shape)} @ {tuple(w.shape)}/"
                         f"{tuple(wm.shape)}")
    kw = dict(bm=bm, bk=bk, bn=bn)
    y = event_matmul(x, w, w_occ, threshold=threshold, **kw)
    macs = event_matmul(m, wm, w_occ, threshold=0.0, **kw)
    return y, macs
