"""Mixture-of-Experts channel block, token-choice top-k (PyTorch port).

Dispatch is capacity-based with the reference's slot layout: the c-th
token routed to expert e (in the stable order of expert ids) takes slot
``dest * E_loc * C3 + loc_e * C3 + c`` (``dest = e // E_loc``, ``loc_e =
e % E_loc``), ``C3 = max(1, ceil(T * k / E * cf))`` from the shard's own T
tokens, and tokens past ``C3`` go to one out-of-bounds row and are
dropped.  ``aux`` carries the five scalars of the reference: the
load-balance and z losses, the largest and mean expert load and the
dropped fraction.

Expert parallelism (the reference's ``_local_moe`` with ``ep = |data|``
and ``tp = 1``): :func:`shard_experts` gives each rank of a process group
the weights of ``E / ep`` experts and records the group on the block.
Then the dispatch buffer goes to the experts' owners by one
``all_to_all`` and comes back the same way, ``counts`` are summed and
``mean_prob``, ``z_loss`` and ``dropped_frac`` averaged over the group.
Without a group the block holds every expert and runs no collective.

Tensor parallelism (the reference's ``tp`` axis): on a model placed by
``sharding.shard_params`` each rank holds its block of every expert's
(and the shared experts') feed-forward dim; routing is replicated, the
expert FFN is one Megatron region (``copy_to`` in, ``psum`` out).  With
``sp_dispatch`` (``PerfFlags.moe_sp_dispatch``) each rank ships its
``d / tp`` slice of every routed token through the all-to-all, gathers
``d`` for the FFN, reduce-scatters its output back to its slice, and the
combined rows are gathered over ``d`` at the end; the gate weights meet
the slices through ``copy_to``.  Without a model group ``sp_dispatch``
slices nothing (the reference's ``tp = 1``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import collectives as C
from repro_torch.models.common import ModelCfg, MoECfg
from repro_torch.models.layers import ACTS, Params

#: the expert-sharded leaves of an :class:`MoE` block (leading axis E)
EXPERT_LEAVES = ("wi", "wg", "wo")


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


def shard_experts(model, group) -> int:
    """Give every :class:`MoE` block of ``model`` this rank's block of
    experts over ``group`` (experts ``[r * E_loc, (r + 1) * E_loc)``,
    ``E_loc = E / |group|``) and record the group: ``moe`` then runs
    expert-parallel.  Call it before ``step.param_tree``.  Returns the
    number of blocks sharded."""
    n, r = C.group_size(group), C.group_rank(group)
    done = 0
    for blk in model.modules():
        if not isinstance(blk, MoE):
            continue
        if getattr(blk, "ep_group", None) is not None:
            raise ValueError("experts are sharded already")
        E = blk.wi.shape[0]
        if E % n:
            raise ValueError(f"{E} experts over {n} ranks")
        e = E // n
        with torch.no_grad():
            for name in EXPERT_LEAVES:
                p = getattr(blk, name)
                p.data = p.data[r * e:(r + 1) * e].clone()
                p.ep_group = group      # read by step.expert_sharded
        blk.ep_group = group
        done += 1
    return done


def moe(x: torch.Tensor, p: MoE, m: MoECfg, cfg: ModelCfg, *,
        decode: bool = False, sp_dispatch: bool | None = None, ctx=None):
    """MoE block.  x: (B, S, d) (this rank's rows under expert
    parallelism; every position, replicated over a model group in
    ``ctx``).  ``sp_dispatch`` defaults to ``ctx``'s flag.  Returns (y,
    aux dict of 0-d tensors)."""
    tp = None if ctx is None else ctx.tp_group
    if sp_dispatch is None:
        sp_dispatch = ctx is not None and ctx.flags.moe_sp_dispatch
    sp_dispatch = sp_dispatch and tp is not None
    group = getattr(p, "ep_group", None)
    ep = C.group_size(group)
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    E_loc = E // ep
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
    counts = C.all_reduce_(counts, group)
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    lb_loss = E * (frac * C.pmean(probs.mean(dim=0), group)).sum()
    z_loss = C.pmean(torch.logsumexp(logits, dim=-1).square().mean(), group)

    # ---- dispatch slots ----------------------------------------------------
    flat_e = ids.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    pos = torch.arange(T * k, device=x.device) - starts[sorted_e]
    keep = pos < C3
    # dest * E_loc * C3 + loc_e * C3 + pos, dest * E_loc + loc_e == e
    slot = torch.where(keep, sorted_e * C3 + pos,
                       torch.full_like(pos, E * C3))     # last row: dropped
    tok = order // k
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "max_expert_load": counts.max(), "mean_expert_load": counts.mean(),
           "dropped_frac": C.pmean(1.0 - keep.float().mean(), group)}

    # each rank of a model group ships its d-slice of a token (sp_dispatch)
    payload = C.scatter_to(xf, 1, tp) if sp_dispatch else xf
    dd = payload.shape[1]
    send = payload.new_zeros((E * C3 + 1, dd))
    send[slot] = payload[tok]
    if group is None:
        xe = send[:-1].reshape(E, C3, dd)
    else:
        # (ep_dest, E_loc, C3) blocks out; (ep_src, E_loc, C3) blocks in
        recv = C.all_to_all(send[:-1], group)
        xe = recv.reshape(ep, E_loc, C3, dd).transpose(0, 1) \
                 .reshape(E_loc, ep * C3, dd)
    xe = C.all_gather(xe, 2, tp) if sp_dispatch else C.copy_to(xe, tp)

    # ---- expert FFN (its ff dim split over a model group) -----------------
    h = torch.einsum("ecd,edf->ecf", xe, p.wi)
    g = torch.einsum("ecd,edf->ecf", xe, p.wg)
    ye = torch.einsum("ecf,efd->ecd", act(g) * h, p.wo)
    ye = C.reduce_scatter(ye, 2, tp) if sp_dispatch else C.psum(ye, tp)

    # ---- return path -------------------------------------------------------
    if group is not None:
        ye = C.all_to_all(ye.reshape(E_loc, ep, C3, dd).transpose(0, 1)
                          .reshape(E * C3, dd), group)
    back = torch.cat([ye.reshape(E * C3, dd), ye.new_zeros((1, dd))])
    gate_sorted = gate.reshape(T * k)[order] * keep
    if sp_dispatch:
        gate_sorted = C.copy_to(gate_sorted, tp)
    contrib = back[slot] * gate_sorted[:, None].to(back.dtype)
    y = back.new_zeros((T, dd)).index_add(0, tok, contrib)
    if sp_dispatch:
        y = C.gather_from(y, 1, tp)

    # ---- shared (always-on) experts ---------------------------------------
    if m.n_shared_experts:
        xs = C.copy_to(xf, tp)
        y = y + C.psum((act(xs @ p.s_wg) * (xs @ p.s_wi)) @ p.s_wo, tp)
    return y.reshape(B, S, d).to(x.dtype), aux
