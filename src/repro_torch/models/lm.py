"""Decoder-only LM assembling the mixers and MLPs of layers.py and moe.py
(PyTorch port).

:class:`LM` holds the embedding, the final norm, the untied unembedding
where there is one, and every block as one ``ModuleList`` in execution
order: ``prefix``, ``n_repeats`` times ``pattern``, ``suffix`` (the JAX
package stacks the repeats on a leading axis and scans over it).

Entry points, with the reference's names:
  init_params(cfg, key, device) / params_from_numpy(cfg, tree, device)
  draw_order(model, key)                -> the reference's key schedule
  params_to_numpy(model) / param_layout(model)  -> the reference's tree
  init_cache(cfg, B, max_len, device)   -> one cache dict per block
  cache_spec(cfg, ctx)                  -> its sharding specs, per block
  abstract_params(cfg) / abstract_cache(cfg, B, max_len) -> the same on
                                           ``meta`` tensors (the dry-run)
  forward(model, tokens)                -> (final hidden states, aux)
  logits_from_h(model, h)               -> float32 logits
  loss_fn(model, batch)                 -> (total loss, metrics)
  prefill(model, tokens)                -> (last-position logits, cache)
  decode_step(model, tokens, cache, pos) -> (logits, cache)

A block's decode cache is ``{"k", "v"}`` (B, W, K, hd) for attention,
``{"conv", "state"}`` for SSD and ``{"conv", "h"}`` for RG-LRU.

Tensor parallelism: a model placed by ``sharding.shard_params`` runs
every function above over its model group.  The vocabulary is split:
the embedding looks up this rank's rows (other ids give zeros) and sums
over the group; the logits are this rank's columns, and
:func:`sharded_xent` reduces over them with one max and two sums;
:func:`logits_from_h`, :func:`prefill` and :func:`decode_step` return
every column.  Under ``PerfFlags.sp_residual`` (``ShardCtx.seq_sharded``)
the residual stream between blocks holds this rank's block of positions
(Megatron-SP), and the norms applied to it pass their gammas through
``copy_to``.  :func:`init_cache` with the context lays out this rank's
shard of the cache: attention slots split over the group (``ceil(W / n)``
each, a ring of ``n`` times that), the recurrent states' channels or
heads.  :func:`params_to_numpy` gathers the blocks to the reference's
tree on every rank.

With ``cfg.remat == "block"`` a forward that records gradients
recomputes each repeat of the ``pattern`` in the backward
(``torch.utils.checkpoint`` of its blocks together), as the reference's
``jax.checkpoint`` of its scan body does; the prefix and suffix blocks
are not recomputed.  The numbers are the same either way.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import BlockCfg, ModelCfg
from repro_torch.models.layers import (MLP, RGLRU, SSD, Attention, KeyGen,
                                       Params, attention, attention_decode,
                                       dt, layout_to_numpy,
                                       load_tree, matmul_f32, mlp,
                                       model_ctx, module_tree, rglru_mixer,
                                       rms_norm, softcap, ssd_mixer,
                                       stacked_layout)

AUX_SUM = ("moe_lb_loss", "moe_z_loss", "dropped_frac")
AUX_MAX = ("max_expert_load",)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

class Block(Params):
    """One residual block: a mixer, then a dense or MoE channel MLP."""

    def __init__(self, blk: BlockCfg, cfg: ModelCfg, dtype, device):
        super().__init__(dtype, device)
        d = cfg.d_model
        self.const("norm1", torch.zeros(d))
        if blk.kind == "attn":
            self.attn = Attention(cfg, dtype, device)
        elif blk.kind == "ssd":
            self.ssd = SSD(cfg, blk.ssd, dtype, device)
        elif blk.kind == "rglru":
            self.rglru = RGLRU(cfg, blk.rglru, dtype, device)
        else:
            raise ValueError(blk.kind)
        if blk.moe is not None:
            self.const("norm2", torch.zeros(d))
            self.moe = moe_lib.MoE(cfg, blk.moe, dtype, device)
        elif blk.d_ff:
            self.const("norm2", torch.zeros(d))
            self.mlp = MLP(d, blk.d_ff, dtype, device)
        if blk.post_norms:
            self.const("norm1_post", torch.zeros(d))
            self.const("norm2_post", torch.zeros(d))


class LM(Params):
    def __init__(self, cfg: ModelCfg, device):
        dtype = dt(cfg.param_dtype)
        super().__init__(dtype, device)
        self.cfg = cfg
        self.weight("embed", (cfg.vocab_size, cfg.d_model), cfg.d_model)
        self.const("final_norm", torch.zeros(cfg.d_model))
        if not cfg.tie_embeddings:
            self.weight("unembed", (cfg.d_model, cfg.vocab_size),
                        cfg.d_model)
        self.blocks = nn.ModuleList(Block(b, cfg, dtype, device)
                                    for b in cfg.all_blocks())


def draw_order(model: LM, key):
    """The reference's key schedule for ``model``'s weights: ``(module,
    KeyGen)`` pairs in draw order.  ``model`` itself first (``embed``,
    then ``unembed`` if untied) and the prefix blocks from the top
    :class:`KeyGen` of ``key``; pattern block ``j`` of repeat ``r`` from
    ``KeyGen(split(kg(), n_repeats)[r])`` (the reference's ``vmap`` over
    the split keys); then the suffix blocks from the top ``KeyGen``.  A
    module's ``reset_parameters`` takes one key of its ``KeyGen`` per
    weight."""
    cfg = model.cfg
    kg = KeyGen(key)
    yield model, kg
    blocks = iter(model.blocks)
    for _ in cfg.prefix:
        yield next(blocks), kg
    if cfg.n_repeats:
        for k in prng.split_words(kg(), cfg.n_repeats):
            kg_r = KeyGen(k)
            for _ in cfg.pattern:
                yield next(blocks), kg_r
    for _ in cfg.suffix:
        yield next(blocks), kg


def init_params(cfg: ModelCfg, key=0,
                device: "str | torch.device" = "cuda") -> LM:
    """An :class:`LM` with the reference's ``init_params(cfg, key)``
    weights, bit for bit, drawn on ``device`` in :func:`draw_order`.
    ``key`` is a ``prng.PRNGKey``; an ``int`` is read as
    ``prng.PRNGKey(key)``."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    for module, kg in draw_order(model, key):
        module.reset_parameters(kg)
    return model


def abstract_params(cfg: ModelCfg) -> LM:
    """An :class:`LM` of ``cfg``'s shapes and dtypes on ``meta`` tensors,
    which allocate nothing (the reference's ``jax.eval_shape`` of
    ``init_params``): nothing is drawn."""
    return LM(cfg, torch.device("meta"))


def _block_slices(cfg: ModelCfg, tree: dict):
    """The reference's per-block subtrees, in execution order (the
    ``pattern`` leaves unstacked along their leading repeat axis)."""
    out = [tree[f"pre{i}"] for i in range(len(cfg.prefix))]
    for r in range(cfg.n_repeats):
        def pick(node):
            return ({k: pick(v) for k, v in node.items()}
                    if isinstance(node, dict) else np.asarray(node)[r])
        out += [pick(tree["pattern"][f"blk{j}"])
                for j in range(len(cfg.pattern))]
    return out + [tree[f"suf{i}"] for i in range(len(cfg.suffix))]


def params_from_numpy(cfg: ModelCfg, tree: dict,
                      device: "str | torch.device" = "cuda") -> LM:
    """The JAX package's ``lm.init_params`` tree (as numpy arrays) as an
    :class:`LM` on ``device``, dtypes kept."""
    model = LM(cfg, resolve_device(device))
    load_tree(model, {k: tree[k] for k in ("embed", "final_norm", "unembed")
                      if k in tree})
    for block, sub in zip(model.blocks, _block_slices(cfg, tree)):
        load_tree(block, sub)
    return model


def param_layout(model: LM) -> dict:
    """The reference's parameter tree of ``model``: each leaf the
    parameter that holds it or, under ``pattern``, the tuple of the
    ``n_repeats`` blocks' parameters that the reference stacks on a
    leading axis."""
    cfg = model.cfg
    blocks = list(model.blocks)
    P, J, R = len(cfg.prefix), len(cfg.pattern), cfg.n_repeats
    tree: dict = dict(model.named_parameters(recurse=False))
    tree.update((f"pre{i}", module_tree(blocks[i])) for i in range(P))
    if R:
        tree["pattern"] = {f"blk{j}": stacked_layout(blocks[P + j:P + J * R:J])
                           for j in range(J)}
    tree.update((f"suf{i}", module_tree(b))
                for i, b in enumerate(blocks[P + J * R:]))
    return tree


def params_to_numpy(model: LM) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's tree,
    pattern leaves stacked on the leading repeat axis, as float32 numpy
    arrays (bfloat16 leaves widened exactly).  Leaves split over ranks
    are gathered whole (every rank calls it)."""
    from repro_torch.distributed.sharding import gather_layout
    return layout_to_numpy(gather_layout(param_layout(model)))


# --------------------------------------------------------------------------
# Decode cache
# --------------------------------------------------------------------------

def slots(blk: BlockCfg, max_len: int, n: int = 1) -> int:
    """An attention block's decode slots on each of ``n`` ranks: the
    ring of ``min(window, max_len)`` slots of a window block, or
    ``max_len``, rounded up to a multiple of ``n`` and split.  A ring of
    at least ``window`` slots under the mask ``0 <= pos - kv_pos <
    window`` attends to the same positions whatever its size."""
    W = min(blk.window, max_len) if blk.window else max_len
    return -(-W // n)


def _block_cache(blk: BlockCfg, cfg: ModelCfg, B: int, max_len: int,
                 dtype, device, n: int = 1) -> dict:
    z = lambda *shape, dtype=dtype: torch.zeros(shape, dtype=dtype,
                                                device=device)
    if blk.kind == "attn":
        W = slots(blk, max_len, n)
        return {"k": z(B, W, cfg.n_kv_heads, cfg.head_dim),
                "v": z(B, W, cfg.n_kv_heads, cfg.head_dim)}
    if blk.kind == "ssd":
        s = blk.ssd
        H = s.d_inner // s.head_dim
        conv_ch = s.d_inner // n + 2 * s.n_groups * s.d_state
        return {"conv": z(B, s.d_conv - 1, conv_ch),
                "state": z(B, H // n, s.head_dim, s.d_state,
                           dtype=torch.float32)}
    if blk.kind == "rglru":
        r = blk.rglru
        return {"conv": z(B, r.d_conv - 1, r.d_rnn // n),
                "h": z(B, r.d_rnn // n, dtype=torch.float32)}
    raise ValueError(blk.kind)


def init_cache(cfg: ModelCfg, B: int, max_len: int,
               device: "str | torch.device" = "cuda", ctx=None
               ) -> list[dict]:
    """The decode cache; with a model group in ``ctx``, this rank's shard
    of it (module docstring)."""
    return _cache(cfg, B, max_len, resolve_device(device), ctx)


def abstract_cache(cfg: ModelCfg, B: int, max_len: int) -> list[dict]:
    """:func:`init_cache`'s layout on ``meta`` tensors."""
    return _cache(cfg, B, max_len, torch.device("meta"))


def _cache(cfg: ModelCfg, B: int, max_len: int, device, ctx=None
           ) -> list[dict]:
    n = 1 if ctx is None or ctx.tp_group is None else ctx.tp_size
    return [_block_cache(b, cfg, B, max_len, dt(cfg.param_dtype), device, n)
            for b in cfg.all_blocks()]


def cache_spec(cfg: ModelCfg, ctx) -> list[dict]:
    """Sharding specs of the decode cache (``distributed.sharding``), one
    dict per block as :func:`init_cache` lays it out: the KV sequence over
    `model` (flash-decoding), recurrent states channel-sharded over
    `model`.  The JAX package stacks the pattern's repeats on a leading
    axis; here each block has its own entry, so the specs are the JAX
    package's less the repeat axis.  A window block holds ``min(window,
    max_len)`` slots in both packages' ``init_cache`` (the reference's
    serving engine grows it to ``max_len``, ROADMAP reference fault 2;
    the specs follow this layout)."""
    dp = ctx.dp_spec

    def blk_spec(blk: BlockCfg) -> dict:
        if blk.kind == "attn":
            return {"k": (dp, ctx.tp, None, None),
                    "v": (dp, ctx.tp, None, None)}
        if blk.kind == "ssd":
            return {"conv": (dp, None, ctx.tp),
                    "state": (dp, ctx.tp, None, None)}
        return {"conv": (dp, None, ctx.tp), "h": (dp, ctx.tp)}
    return [blk_spec(b) for b in cfg.all_blocks()]


# --------------------------------------------------------------------------
# Block application
# --------------------------------------------------------------------------

def _zero_aux(device) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_SUM + AUX_MAX}


def _merge_aux(acc: dict, new: dict) -> dict:
    out = dict(acc)
    for k in AUX_SUM:
        if k in new:
            out[k] = acc[k] + new[k]
    for k in AUX_MAX:
        if k in new:
            out[k] = torch.maximum(acc[k], new[k])
    return out


def apply_block(h, p: Block, blk: BlockCfg, cfg: ModelCfg, *,
                positions=None, cache=None, pos=None, decode: bool = False,
                collect_cache: bool = False, ctx=None, sp: bool = False):
    """One residual block.  Returns (h, new_cache, aux).

    ``collect_cache`` (prefill) emits the decode cache of a full-sequence
    pass (attention K/V, SSD conv + state, RG-LRU conv + h).  ``ctx``,
    ``sp``: tensor parallelism, ``h`` sequence-sharded under ``sp``
    (module docstring)."""
    aux: dict = {}
    g = None if ctx is None else ctx.tp_group
    # under sp a norm sees this rank's positions: its gamma's gradient is
    # a partial sum
    gam = (lambda t: C.copy_to(t, g)) if sp else (lambda t: t)
    kw = {} if ctx is None else {"ctx": ctx, "sp": sp}
    x = rms_norm(h, gam(p.norm1), cfg.norm_eps)
    new_cache = cache
    if blk.kind == "attn":
        if decode:
            y, ck, cv = attention_decode(x, p.attn, blk, cfg,
                                         cache_k=cache["k"],
                                         cache_v=cache["v"], pos=pos, **kw)
            new_cache = {"k": ck, "v": cv}
        elif collect_cache:
            y, (ck, cv) = attention(x, p.attn, blk, cfg,
                                    positions=positions, return_kv=True,
                                    **kw)
            new_cache = {"k": ck, "v": cv}
        else:
            y = attention(x, p.attn, blk, cfg, positions=positions, **kw)
    elif blk.kind == "ssd":
        y, conv, state = ssd_mixer(
            x, p.ssd, blk.ssd, cfg, decode=decode,
            conv_state=None if cache is None else cache["conv"],
            ssm_state=None if cache is None else cache["state"], **kw)
        if cache is not None or collect_cache:
            new_cache = {"conv": conv, "state": state}
    else:
        y, conv, hst = rglru_mixer(
            x, p.rglru, blk.rglru, cfg, decode=decode,
            conv_state=None if cache is None else cache["conv"],
            h_state=None if cache is None else cache["h"], **kw)
        if cache is not None or collect_cache:
            new_cache = {"conv": conv, "h": hst}
    if blk.post_norms:
        y = rms_norm(y, gam(p.norm1_post), cfg.norm_eps)
    h = h + y

    if blk.moe is not None or blk.d_ff:
        x = rms_norm(h, gam(p.norm2), cfg.norm_eps)
        if blk.moe is not None:
            # routing reads every position: the block is replicated
            if sp:
                x = C.gather_from(x, 1, g)
            y, aux = moe_lib.moe(x, p.moe, blk.moe, cfg, decode=decode,
                                 ctx=ctx)
            if sp:
                y = C.scatter_to(y, 1, g)
        else:
            y = mlp(x, p.mlp, cfg, **kw)
        if blk.post_norms:
            y = rms_norm(y, gam(p.norm2_post), cfg.norm_eps)
        h = h + y
    return h, new_cache, aux


# --------------------------------------------------------------------------
# Forward, prefill, decode
# --------------------------------------------------------------------------

def lookup(embed: torch.Tensor, tokens: torch.Tensor, ctx=None):
    """Rows of ``embed`` for ``tokens``; with a model group in ``ctx``,
    ``embed`` holds this rank's block of rows, other ids look up zeros,
    and the ranks' rows are summed."""
    g = None if ctx is None else ctx.tp_group
    if g is None:
        return embed[tokens]
    n_loc = embed.shape[0]
    local = tokens - ctx.tp_rank * n_loc
    inside = (local >= 0) & (local < n_loc)
    rows = embed[local.clamp(0, n_loc - 1)]
    return C.psum(torch.where(inside[..., None], rows, 0.0), g)


def embed_tokens(model: LM, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None):
    cfg = model.cfg
    h = lookup(model.embed, tokens, model_ctx(model)).to(
        dt(cfg.compute_dtype))
    if cfg.emb_scale:
        # sqrt(d) in float32, then in the compute dtype (a host scalar)
        h = h * torch.sqrt(torch.tensor(float(cfg.d_model))).to(h.dtype)
    if frontend_embeds is not None:
        h = torch.cat([frontend_embeds.to(h.dtype), h], dim=1)
    return h


def _blocks(model: LM):
    return zip(model.blocks, model.cfg.all_blocks())


def _apply_blocks(h, aux: dict, blocks, cfg: ModelCfg, positions, ctx, sp):
    for p, blk in blocks:
        h, _, a = apply_block(h, p, blk, cfg, positions=positions, ctx=ctx,
                              sp=sp)
        aux = _merge_aux(aux, a)
    return h, aux


def residual_in(h: torch.Tensor, ctx):
    """(the residual stream, whether it is sequence-sharded)."""
    if ctx is not None and ctx.seq_sharded(h.shape[1]):
        return C.scatter_to(h, 1, ctx.tp_group), True
    return h, False


def _final_norm(h, gamma, cfg, ctx, sp: bool):
    return rms_norm(h, C.copy_to(gamma, ctx.tp_group) if sp else gamma,
                    cfg.norm_eps)


def _forward(model: LM, tokens: torch.Tensor, frontend_embeds=None):
    """(final hidden states, aux, sequence-sharded?)."""
    cfg, ctx = model.cfg, model_ctx(model)
    h = embed_tokens(model, tokens, frontend_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    h, sp = residual_in(h, ctx)
    aux = _zero_aux(h.device)
    blocks = list(_blocks(model))
    P, J = len(cfg.prefix), len(cfg.pattern)
    h, aux = _apply_blocks(h, aux, blocks[:P], cfg, positions, ctx, sp)
    # the reference checkpoints its scan body, one repeat of the pattern
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for r in range(cfg.n_repeats):
        group = blocks[P + r * J:P + (r + 1) * J]
        if remat:
            h, aux = checkpoint(_apply_blocks, h, aux, group, cfg,
                                positions, ctx, sp, use_reentrant=False)
        else:
            h, aux = _apply_blocks(h, aux, group, cfg, positions, ctx, sp)
    h, aux = _apply_blocks(h, aux, blocks[P + cfg.n_repeats * J:], cfg,
                           positions, ctx, sp)
    return _final_norm(h, model.final_norm, cfg, ctx, sp), aux, sp


def forward(model: LM, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward -> (final hidden states, aux)."""
    h, aux, sp = _forward(model, tokens, frontend_embeds)
    if sp:
        h = C.gather_from(h, 1, model_ctx(model).tp_group)
    return h, aux


def vocab_logits(model, w: torch.Tensor, h: torch.Tensor, softcap_=None,
                 sp: bool = False) -> torch.Tensor:
    """float32 ``h @ w``: with a model group, ``w`` holds this rank's
    columns and so do the logits; ``h`` (sequence-sharded under ``sp``)
    enters the group's region."""
    ctx = model_ctx(model)
    if ctx is not None:
        g = ctx.tp_group
        h = C.all_gather(h, 1, g) if sp else C.copy_to(h, g)
    B, S, d = h.shape
    logits = matmul_f32(h.reshape(B * S, d), w).reshape(B, S, -1)
    return softcap(logits, softcap_)


def _unembed(model: LM) -> torch.Tensor:
    return model.embed.t() if model.cfg.tie_embeddings else model.unembed


def gather_vocab(model, logits: torch.Tensor) -> torch.Tensor:
    """Every rank's columns of vocab-split ``logits`` (the logits as they
    are without a model group)."""
    ctx = model_ctx(model)
    return logits if ctx is None else C.gather_from(logits, -1,
                                                    ctx.tp_group)


def logits_from_h(model: LM, h: torch.Tensor) -> torch.Tensor:
    """float32 logits of every vocabulary column for hidden states ``h``
    (whole on every rank)."""
    return gather_vocab(model, vocab_logits(model, _unembed(model), h,
                                            model.cfg.final_softcap))


class _VocabLSE(torch.autograd.Function):
    """``logsumexp`` over logits whose last dim is split over a group:
    the max and the sum of exponentials meet in all-reduces.  It computes
    ``torch.logsumexp``'s own steps (max, masked where infinite; the sum
    of ``exp(x - max)``; log plus max) and its backward ``g * exp(x -
    lse)``, so that one rank gives its bits."""

    @staticmethod
    def forward(ctx, x, group):
        m = C.pmax(x.amax(-1, keepdim=True), group)
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        total = C.psum((x - m).exp().sum(-1), group)
        lse = total.log() + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * (x - lse[..., None]).exp(), None


def sharded_xent(logits: torch.Tensor, labels: torch.Tensor,
                 weights: Optional[torch.Tensor] = None, group=None,
                 tp_group=None):
    """(mean cross entropy, mean squared log-normaliser) of float32
    ``logits`` (B, S, V) against ``labels`` (B, S), weighted.  The label's
    log-likelihood is a gather where the reference sums a one-hot product:
    that sum has one non-zero term, so both are exact.  A label outside
    [0, V) matches no column of the one-hot, so its log-likelihood is 0
    (its nll is ``lse``, and its gradient has no -1 term).  The gather
    reads a clamped index: on CUDA an out-of-range index is a device-side
    assert, which poisons the context.

    With a data-parallel ``group`` the rows are this rank's share of the
    global batch and the means are the global batch's: the weight sum is
    summed over the group, and each returned value is this rank's term of
    the global mean (the terms of all ranks sum to it).

    With a model group ``tp_group`` the logits are this rank's block of
    the vocabulary (columns ``[rank * V_loc, (rank + 1) * V_loc)``): the
    log-normaliser meets in a max and a sum over the group, and each
    rank gathers the labels that fall in its block (others, and labels
    outside [0, V), add 0) before one more sum."""
    logits = logits.float()
    V = logits.shape[-1]
    labels = labels.long()
    if tp_group is None:
        lse = torch.logsumexp(logits, dim=-1)
    else:
        lse = _VocabLSE.apply(logits, tp_group)
        labels = labels - C.group_rank(tp_group) * V
    inside = (labels >= 0) & (labels < V)
    ll = logits.gather(-1, labels.clamp(0, V - 1)[..., None])[..., 0]
    nll = lse - C.psum(torch.where(inside, ll, 0.0), tp_group)
    if weights is None:
        weights = torch.ones_like(nll)
    denom = torch.clamp(C.all_reduce_(weights.sum(), group), min=1.0)
    loss = (nll * weights).sum() / denom
    z_loss = (lse.square() * weights).sum() / denom
    return loss, z_loss


def loss_fn(model: LM, batch: dict, *, z_weight: float = 1e-4, group=None):
    """batch: {"tokens" (B, S'), "labels" (B, S)[, "frontend_embeds"]
    [, "weights"]}.  Returns (total loss, metrics): the cross entropy plus
    ``z_weight`` times the z-loss and, with MoE blocks, the router's
    load-balance and z terms at the first MoE block's weights.

    With a data-parallel ``group`` the batch is this rank's rows and the
    metrics are the global batch's on every rank; the total is this
    rank's term of the global objective, whose gradients, summed over the
    group, are the global objective's (the MoE aux terms are replicated
    values whose collectives pass cotangents through,
    ``collectives.psum``)."""
    cfg, ctx = model.cfg, model_ctx(model)
    h, aux, sp = _forward(model, batch["tokens"],
                          batch.get("frontend_embeds"))
    logits = vocab_logits(model, _unembed(model), h, cfg.final_softcap, sp)
    loss, z_loss = sharded_xent(logits, batch["labels"], batch.get("weights"),
                                group, None if ctx is None else ctx.tp_group)
    total = loss + z_weight * z_loss
    m = next((b.moe for b in cfg.all_blocks() if b.moe is not None), None)
    if m is not None:
        total = (total + m.router_aux_weight * aux["moe_lb_loss"]
                 + m.router_z_weight * aux["moe_z_loss"])
    if group is not None:
        loss = C.all_reduce_(loss.detach().clone(), group)
        z_loss = C.all_reduce_(z_loss.detach().clone(), group)
    return total, {"loss": loss, "z_loss": z_loss, **aux}


def prefill(model: LM, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None):
    """Full-context prefill: (last-position logits (B, V), cache).  The
    cache has ``init_cache``'s layout at max_len == S (window blocks keep
    the last ``window`` positions); the serving engine places it into its
    decode buffers."""
    cfg, ctx = model.cfg, model_ctx(model)
    h = embed_tokens(model, tokens, frontend_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    h, sp = residual_in(h, ctx)
    cache: list[Any] = []
    for p, blk in _blocks(model):
        h, c, _ = apply_block(h, p, blk, cfg, positions=positions,
                              collect_cache=True, ctx=ctx, sp=sp)
        cache.append(c)
    h = _final_norm(h, model.final_norm, cfg, ctx, sp)
    if sp:
        h = C.gather_from(h, 1, ctx.tp_group)
    return logits_from_h(model, h[:, -1:])[:, 0], cache


def decode_step(model: LM, tokens: torch.Tensor, cache: list, pos: int):
    """One-token decode.  tokens: (B, 1); ``pos`` the index of the token
    (the cache holds positions before it).  Attention caches are updated
    in place.  Returns (logits (B, V), cache)."""
    cfg, ctx = model.cfg, model_ctx(model)
    h = embed_tokens(model, tokens)
    h, sp = residual_in(h, ctx)
    new_cache = []
    for (p, blk), c in zip(_blocks(model), cache):
        h, c, _ = apply_block(h, p, blk, cfg, cache=c, pos=pos, decode=True,
                              ctx=ctx, sp=sp)
        new_cache.append(c)
    h = _final_norm(h, model.final_norm, cfg, ctx, sp)
    if sp:
        h = C.gather_from(h, 1, ctx.tp_group)
    return logits_from_h(model, h)[:, 0], new_cache
