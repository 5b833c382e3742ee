"""int8-compressed gradient mean with error feedback (PyTorch port of the
gradient part of ``repro.distributed.collectives``), for one data-parallel
replica.

    q      = quantize_int8(g + err)      # per-leaf scale = max|.| / 127
    g_hat  = psum(q) * scale / n
    err'   = (g + err) - dequant(q)      # residual, fed back next step

Error feedback keeps the accumulated quantization error bounded.  With one
replica the reference's ``pmax`` and ``psum`` over the data-parallel axes
are identities and ``n`` is 1, so the mean is the replica's own
dequantized value; the trainer's ``compress_grads`` mode runs it so.  The
island primitives (``ring_shift``, ``gather_islands``) are not ported: the
port's sharded search keeps its islands on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map

_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_int8(x: torch.Tensor):
    """(int8 q, float32 scale) with ``scale = max(max|x|, 1e-30) / 127``
    (a product with the float32 reciprocal of 127, as XLA compiles the
    reference's division) and ``q = clip(round(x / scale), -127, 127)``
    (half to even, as ``jnp.round``)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-30) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_mean(x: torch.Tensor, err: torch.Tensor):
    """One leaf: the error-feedback int8 mean over one replica.  Returns
    (mean estimate in float32, new error)."""
    xf = x.float() + err
    q, scale = quantize_int8(xf)
    return dequantize_int8(q, scale), xf - dequantize_int8(q, scale)


def compressed_grad_mean(grads, err_tree):
    """Tree version (nested dicts).  Returns (mean gradients in float32,
    new error tree)."""
    if not isinstance(grads, dict):
        return compressed_psum_mean(grads, err_tree)
    out = {k: compressed_grad_mean(grads[k], err_tree[k]) for k in grads}
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()})


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
