"""Mixture-of-Experts channel block, token-choice top-k (PyTorch port).

One device holds every expert, so this is the JAX package's per-device
body with one expert-parallel shard and no collectives.  Dispatch is
capacity-based with the reference's slot layout: the c-th token routed to
expert e (in the stable order of expert ids) takes slot ``e * C3 + c``,
``C3 = max(1, ceil(T * k / E * cf))``, and tokens past ``C3`` are dropped.
``aux`` carries the five scalars of the reference: the load-balance and
z losses, the largest and mean expert load and the dropped fraction.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import ModelCfg, MoECfg
from repro_torch.models.layers import ACTS, Params


class MoE(Params):
    def __init__(self, cfg: ModelCfg, m: MoECfg, dtype, device):
        super().__init__(dtype, device)
        d, E = cfg.d_model, m.n_experts
        self.weight("router", (d, E), d, torch.float32)
        self.weight("wi", (E, d, m.d_ff), d)
        self.weight("wg", (E, d, m.d_ff), d)
        self.weight("wo", (E, m.d_ff, d), m.d_ff)
        if m.n_shared_experts:
            ffs = m.d_ff * m.n_shared_experts
            self.weight("s_wi", (d, ffs), d)
            self.weight("s_wg", (d, ffs), d)
            self.weight("s_wo", (ffs, d), ffs)


def moe_param_specs(cfg: ModelCfg, m: MoECfg, ctx) -> dict:
    """Sharding specs of an :class:`MoE` block's leaves
    (``distributed.sharding``): experts over `data` when there is a mesh,
    their feed-forward dims over `model`."""
    ep = "data" if ctx.mesh is not None else None
    tp = ctx.tp
    specs = {"router": (None, None), "wi": (ep, None, tp),
             "wg": (ep, None, tp), "wo": (ep, tp, None)}
    if m.n_shared_experts:
        specs.update({"s_wi": (None, tp), "s_wg": (None, tp),
                      "s_wo": (tp, None)})
    return specs


def moe(x: torch.Tensor, p: MoE, m: MoECfg, cfg: ModelCfg, *,
        decode: bool = False):
    """MoE block.  x: (B, S, d).  Returns (y, aux dict of 0-d tensors)."""
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    cf = m.decode_capacity_factor if decode else m.capacity_factor
    C3 = max(1, math.ceil(T * k / E * cf))
    act = ACTS[cfg.act_fn]

    xf = x.reshape(T, d)
    logits = xf.float() @ p.router                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1)             # (T, k), descending
    gate = gate / gate.sum(dim=-1, keepdim=True)

    # ---- aux: load-balance + z losses, the largest expert load -----------
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts = counts.index_add(0, ids.reshape(-1),
                              torch.ones(T * k, device=x.device))
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    lb_loss = E * (frac * probs.mean(dim=0)).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()

    # ---- dispatch slots ----------------------------------------------------
    flat_e = ids.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    pos = torch.arange(T * k, device=x.device) - starts[sorted_e]
    keep = pos < C3
    slot = torch.where(keep, sorted_e * C3 + pos,
                       torch.full_like(pos, E * C3))     # last row: dropped
    tok = order // k
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "max_expert_load": counts.max(), "mean_expert_load": counts.mean(),
           "dropped_frac": 1.0 - keep.float().mean()}

    send = xf.new_zeros((E * C3 + 1, d))
    send[slot] = xf[tok]
    xe = send[:-1].reshape(E, C3, d)

    # ---- expert FFN --------------------------------------------------------
    h = torch.einsum("ecd,edf->ecf", xe, p.wi)
    g = torch.einsum("ecd,edf->ecf", xe, p.wg)
    ye = torch.einsum("ecf,efd->ecd", act(g) * h, p.wo)

    # ---- return path -------------------------------------------------------
    back = torch.cat([ye.reshape(E * C3, d), ye.new_zeros((1, d))])
    gate_sorted = gate.reshape(T * k)[order]
    contrib = back[slot] * (gate_sorted * keep)[:, None].to(back.dtype)
    y = back.new_zeros((T, d)).index_add(0, tok, contrib)

    # ---- shared (always-on) experts ---------------------------------------
    if m.n_shared_experts:
        y = y + (act(xf @ p.s_wg) * (xf @ p.s_wi)) @ p.s_wo
    return y.reshape(B, S, d).to(x.dtype), aux
