"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that a block-sparse product needs.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet,
dense): 495 TFLOP/s for float32 products on the tensor cores (as TF32;
the port's float32 kernel runs 3xTF32 there, so no faithful float32 path
reads above this), 1,979 TOP/s int8, 989 TFLOP/s bf16, and 3.35 TB/s of
HBM bandwidth.

``product_need`` counts what one product ``x @ W`` needs at the
kernel's 128-wide tiles: a (m, k, n) tile triple is needed when the
activation tile (m, k) holds an event and the weight tile (k, n) a
nonzero; its operations are ``2 * rows * depth * cols`` of the tile cut
to the true matrix edges.  Each needed input tile is read once and each
output element written once.  Frozen with the tile edge of
``repro_torch.kernels.event_matmul.ops.KERNEL_TILE`` at commit cbf4587.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TILE = 128
PEAK_OPS = {"float32": 495e12, "int8": 1979e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
#: Bytes of one operand element and of one output element, by kind.
ELEMENT_BYTES = {"float32": (4, 4), "int8": (1, 4), "bfloat16": (2, 2)}


@dataclasses.dataclass(frozen=True)
class Need:
    ops: float
    bytes: float
    kind: str

    @property
    def seconds(self) -> float:
        """The least time the card could take: the larger of the
        operations over the kind's peak and the bytes over HBM's."""
        return max(self.ops / PEAK_OPS[self.kind],
                   self.bytes / PEAK_BYTES_PER_S)


def _edges(n: int, tile: int = TILE) -> np.ndarray:
    """The true widths of the tiles that cover ``n``."""
    nb = -(-n // tile)
    w = np.full(nb, tile, np.float64)
    if nb:
        w[-1] = n - tile * (nb - 1)
    return w


def tile_any(a: np.ndarray, tile: int = TILE) -> np.ndarray:
    """(rows, cols) bool -> the (rows/tile, cols/tile) map of tiles that
    hold at least one True (edges zero-padded)."""
    r, c = a.shape
    rp, cp = -(-r // tile) * tile, -(-c // tile) * tile
    p = np.zeros((rp, cp), bool)
    p[:r, :c] = a
    return p.reshape(rp // tile, tile, cp // tile, tile).any(axis=(1, 3))


def product_need(act: np.ndarray, occ: np.ndarray, M: int, K: int, N: int,
                 kind: str) -> Need:
    """What ``x (M, K) @ W (K, N)`` needs, from the activation-tile map
    ``act`` (Mb, Kb) and the weight-tile occupancy ``occ`` (Kb, Nb)."""
    rm, rk, rn = _edges(M), _edges(K), _edges(N)
    act = act.astype(np.float64)
    occ = occ.astype(np.float64)
    ops = 2.0 * float(rm @ (act * rk[None, :]) @ (occ @ rn))
    x_tiles = act * (occ.any(axis=1)[None, :])          # (Mb, Kb) needed
    w_tiles = occ * (act.any(axis=0)[:, None])          # (Kb, Nb) needed
    in_b, out_b = ELEMENT_BYTES[kind]
    nbytes = (float(rm @ x_tiles @ rk) + float(rk @ w_tiles @ rn)) * in_b \
        + float(M) * N * out_b
    return Need(ops=ops, bytes=nbytes, kind=kind)


def job_flops(macs: float) -> float:
    """Operations of a job's value products: two per needed MAC."""
    return 2.0 * macs


def mfu_percent(flops: float, seconds: float) -> float:
    """``flops`` over ``seconds`` as a share of the float32-as-TF32 peak."""
    return 100.0 * flops / seconds / PEAK_OPS["float32"]
