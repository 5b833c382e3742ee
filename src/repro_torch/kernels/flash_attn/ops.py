"""Wrapper for the flash-attention kernel.

:func:`flash_attention` launches the CUDA kernel (``csrc/flash_attn.cu``)
on CUDA tensors as they are: the kernel takes the true Sq and Skv,
zero-fills ragged K/V rows in shared memory, masks keys past Skv through
``kv_len`` and stores no row past Sq, so nothing is padded or copied.  On
CPU tensors it runs :func:`..ref.flash_attention_ref` through a padding to
whole :data:`KERNEL_TILE` rows, with the padded keys masked through
``kv_len`` (which keeps non-causal attention exact too) and the padded
query rows sliced off.  :func:`bind_launch` binds the kernel's launch, for
callers that time the launch alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

#: Query rows per block of the CUDA kernel, and the row tile the CPU path
#: pads to.
KERNEL_TILE = 64
#: Largest head dimension the CUDA kernel's shared-memory tiles hold.
MAX_HEAD_DIM = 256


def _pad_seq(a: torch.Tensor) -> torch.Tensor:
    """Zero-pad dim 1 of a (B, S, heads, hd) tensor to whole
    :data:`KERNEL_TILE` rows (the CPU path)."""
    pad = (-a.shape[1]) % KERNEL_TILE
    return F.pad(a, (0, 0, 0, 0, 0, pad)) if pad else a.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, hd) over k/v (B, Skv, K, hd),
    float32, H a multiple of K (query head h reads KV head ``h // (H //
    K)``); ``causal`` masks future keys, ``window`` keys ``window`` or more
    positions back, ``softcap`` caps the scores with ``cap * tanh(s /
    cap)``.  Returns (B, Sq, H, hd) float32.

    CPU tensors run :func:`..ref.flash_attention_ref`; CUDA tensors launch
    the kernel and count the launch in ``flash_attention.launches``."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K
            or Sq == 0 or Skv == 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"fit k/v {tuple(k.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} outside "
                         f"1..{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap {softcap} <= 0")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise TypeError("flash_attention takes float32 q, k and v")
    if not q.device == k.device == v.device:
        raise ValueError("operands on different devices")
    if q.device.type == "cpu":
        qp, kp, vp = (_pad_seq(a) for a in (q, k, v))
        out = flash_attention_ref(qp, kp, vp, causal=causal, window=window,
                                  softcap=softcap,
                                  kv_len=Skv if kp.shape[1] != Skv else None)
        return out[:, :Sq]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    launch, out = bind_launch(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    with torch.cuda.device(q.device):
        err = launch()
    build.check(err, "flash_attn")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def bind_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: int | None = None,
                softcap: float | None = None):
    """Bind one kernel launch to CUDA q/k/v that :func:`flash_attention`
    accepts (made contiguous if they are not).  Returns ``(launch, out)``:
    ``launch()``, called with their device current, runs the kernel on its
    current stream into ``out``, the (B, Sq, H, hd) result, and returns the
    kernel's status code; it neither checks nor counts the launch."""
    q, k, v = (a.contiguous() for a in (q, k, v))
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream

    def launch() -> int:                   # holds the operands alive
        return lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, K, hd, int(causal), window or 0, softcap or 0.0, Skv,
            1.0 / math.sqrt(hd), stream)
    return launch, out
