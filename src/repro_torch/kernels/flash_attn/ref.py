"""Plain PyTorch version of the flash-attention kernel: exact softmax
attention in the JAX oracle's order (scores, divide by ``sqrt(hd)``,
softcap, mask with ``-1e30``, softmax, weighted values)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        kv_len: int | None = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, K, hd), H a multiple of K (query
    head h reads KV head ``h // (H // K)``).  ``kv_len`` masks the keys at
    and beyond it (sequence padding).  Returns (B, Sq, H, hd) in q's
    dtype."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32))
    s = s / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= (qp - kp) < window
    if kv_len is not None:
        ok &= kp < kv_len
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)
