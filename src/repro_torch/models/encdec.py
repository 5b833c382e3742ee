"""Encoder-decoder backbone (whisper-base), PyTorch port.

The audio frontend (log-mel + conv downsampling) is a stub: the encoder
sees ``n_frames`` precomputed frame embeddings (B, n_frames, d).  The
backbone is a bidirectional encoder and a causal decoder with
cross-attention; self-attention uses RoPE in place of whisper's absolute
embeddings, and cross-attention none, as in the JAX package.  The
model-zoo frontend also lowers :class:`EncDecCfg` onto the simulator.

Entry points, with the reference's names: ``init_params`` /
``params_from_numpy`` (and the inverse ``params_to_numpy``, with
``param_layout``), ``encode``, ``decode_train``, ``loss_fn``,
``init_cache`` (its sharding specs ``cache_spec``),
``precompute_cross_cache`` and ``decode_step``;
``abstract_params`` and ``abstract_cache`` build on ``meta`` tensors for
the dry-run.  With
``cfg.remat == "block"`` a forward that records gradients recomputes each
layer in the backward, as the reference's ``jax.checkpoint`` does.

Tensor parallelism (``sharding.shard_params``) as in ``lm``: every layer
is the layers' regions over the model group, the logits are this rank's
vocabulary columns (``lm.sharded_xent`` reduces over them), and under
``PerfFlags.sp_residual`` each stream (encoder, decoder) is
sequence-sharded when the group divides its length; the encoder's output
is whole on every rank.  The decode cache's self-attention slots are
split over the group; the cross-attention K/V stay whole (the
reference's ``cache_spec`` replicates them over `model`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.collectives import all_reduce_
from repro_torch.models.common import BlockCfg, ModelCfg
from repro_torch.models.layers import (MLP, Attention, KeyGen, Params,
                                       attention, attention_decode, dt,
                                       layout_to_numpy, load_tree, mlp,
                                       model_ctx, rms_norm, stacked_layout)
from repro_torch.models.lm import (gather_vocab, lookup, residual_in,
                                   sharded_xent, slots, vocab_logits)


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    d_ff: int
    n_enc_layers: int
    n_dec_layers: int
    n_frames: int = 1500
    act_fn: str = "gelu"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "block"

    @property
    def mc(self) -> ModelCfg:
        """Inner ModelCfg view of the shared attention/MLP widths."""
        return ModelCfg(
            name=self.name, d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            vocab_size=self.vocab_size, act_fn=self.act_fn,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            tie_embeddings=True, param_dtype=self.param_dtype,
            compute_dtype=self.compute_dtype)

    @property
    def n_layers(self) -> int:
        return self.n_enc_layers + self.n_dec_layers

    def param_count(self) -> int:
        d, ff = self.d_model, self.d_ff
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        enc = self.n_enc_layers * (attn + 3 * d * ff + 2 * d)
        dec = self.n_dec_layers * (2 * attn + 3 * d * ff + 3 * d)
        return self.vocab_size * d + enc + dec + 2 * d


_BLK = BlockCfg(kind="attn")


# --------------------------------------------------------------- parameters

class EncBlock(Params):
    def __init__(self, cfg: EncDecCfg, dtype, device):
        super().__init__(dtype, device)
        self.const("norm1", torch.zeros(cfg.d_model))
        self.attn = Attention(cfg.mc, dtype, device)
        self.const("norm2", torch.zeros(cfg.d_model))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


class DecBlock(EncBlock):
    def __init__(self, cfg: EncDecCfg, dtype, device):
        super().__init__(cfg, dtype, device)
        self.const("norm_x", torch.zeros(cfg.d_model))
        self.xattn = Attention(cfg.mc, dtype, device)

    def weights(self):
        """The reference's call order: ``attn``, ``xattn``, ``mlp``."""
        for cname in ("attn", "xattn", "mlp"):
            for name, t, fan_in in getattr(self, cname).weights():
                yield f"{cname}.{name}", t, fan_in


class EncDec(Params):
    def __init__(self, cfg: EncDecCfg, device):
        dtype = dt(cfg.param_dtype)
        super().__init__(dtype, device)
        self.cfg = cfg
        self.weight("embed", (cfg.vocab_size, cfg.d_model), cfg.d_model)
        self.enc = nn.ModuleList(EncBlock(cfg, dtype, device)
                                 for _ in range(cfg.n_enc_layers))
        self.dec = nn.ModuleList(DecBlock(cfg, dtype, device)
                                 for _ in range(cfg.n_dec_layers))
        self.const("enc_norm", torch.zeros(cfg.d_model))
        self.const("dec_norm", torch.zeros(cfg.d_model))


def init_params(cfg: EncDecCfg, key=0,
                device: "str | torch.device" = "cuda") -> EncDec:
    """An :class:`EncDec` with the reference's ``init_params(cfg, key)``
    weights, bit for bit (``key`` a ``prng.PRNGKey``, or an ``int`` read
    as one): ``embed`` from the top :class:`KeyGen`, then encoder block
    ``i`` from ``KeyGen(split(kg(), n_enc_layers)[i])``, then the decoder
    blocks likewise from the next key."""
    dev = resolve_device(device)
    model = EncDec(cfg, dev)
    kg = KeyGen(key)
    model.reset_parameters(kg)
    for stack in (model.enc, model.dec):
        for blk, k in zip(stack, prng.split_words(kg(), len(stack))):
            blk.reset_parameters(KeyGen(k))
    return model


def abstract_params(cfg: EncDecCfg) -> EncDec:
    """An :class:`EncDec` of ``cfg``'s shapes on ``meta`` tensors, which
    allocate nothing; nothing is drawn."""
    return EncDec(cfg, torch.device("meta"))


def params_from_numpy(cfg: EncDecCfg, tree: dict,
                      device: "str | torch.device" = "cuda") -> EncDec:
    """The JAX package's ``encdec.init_params`` tree (as numpy arrays) as
    an :class:`EncDec` on ``device`` (``enc``/``dec`` unstacked)."""
    model = EncDec(cfg, resolve_device(device))
    load_tree(model, {k: tree[k] for k in ("embed", "enc_norm", "dec_norm")})
    for name in ("enc", "dec"):
        stacked = tree[name]
        for i, block in enumerate(getattr(model, name)):
            load_tree(block, _layer(stacked, i))
    return model


def param_layout(model: EncDec) -> dict:
    """The reference's parameter tree of ``model``: each leaf the
    parameter that holds it or, under ``enc`` and ``dec``, the tuple of
    the layers' parameters that the reference stacks on a leading axis."""
    tree: dict = dict(model.named_parameters(recurse=False))
    tree["enc"] = stacked_layout(model.enc)
    tree["dec"] = stacked_layout(model.dec)
    return tree


def params_to_numpy(model: EncDec) -> dict:
    """The inverse of :func:`params_from_numpy` (float32 numpy arrays,
    ``enc``/``dec`` stacked; split leaves gathered, on every rank)."""
    from repro_torch.distributed.sharding import gather_layout
    return layout_to_numpy(gather_layout(param_layout(model)))


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ------------------------------------------------------------------ forward

def _embed(model: EncDec, tokens: torch.Tensor) -> torch.Tensor:
    return lookup(model.embed, tokens, model_ctx(model)).to(
        dt(model.cfg.compute_dtype))


def _layers(fn, h, layers, cfg: EncDecCfg, *args):
    """``h`` through ``fn(h, p, cfg, *args)`` for each layer ``p``, each
    recomputed in the backward under ``cfg.remat == "block"``."""
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for p in layers:
        h = (checkpoint(fn, h, p, cfg, *args, use_reentrant=False) if remat
             else fn(h, p, cfg, *args))
    return h


def _gam(ctx, sp: bool):
    """A norm's gamma as the norm sees it: through ``copy_to`` where the
    stream is sequence-sharded (its gradient is then a partial sum)."""
    return (lambda t: C.copy_to(t, ctx.tp_group)) if sp else (lambda t: t)


def _enc_layer(h, p: EncBlock, cfg: EncDecCfg, positions, ctx=None,
               sp=False):
    mc, gam = cfg.mc, _gam(ctx, sp)
    kw = {} if ctx is None else {"ctx": ctx, "sp": sp}
    x = rms_norm(h, gam(p.norm1), cfg.norm_eps)
    h = h + attention(x, p.attn, _BLK, mc, positions=positions,
                      causal=False, **kw)
    x = rms_norm(h, gam(p.norm2), cfg.norm_eps)
    return h + mlp(x, p.mlp, mc, **kw)


def _dec_layer(h, p: DecBlock, cfg: EncDecCfg, positions, enc_out,
               ctx=None, sp=False):
    mc, gam = cfg.mc, _gam(ctx, sp)
    kw = {} if ctx is None else {"ctx": ctx, "sp": sp}
    x = rms_norm(h, gam(p.norm1), cfg.norm_eps)
    h = h + attention(x, p.attn, _BLK, mc, positions=positions, **kw)
    x = rms_norm(h, gam(p.norm_x), cfg.norm_eps)
    h = h + attention(x, p.xattn, _BLK, mc, positions=positions,
                      causal=False, xkv=enc_out, **kw)
    x = rms_norm(h, gam(p.norm2), cfg.norm_eps)
    return h + mlp(x, p.mlp, mc, **kw)


def _stream(model: EncDec, fn, h, layers, gamma, *args):
    """``h`` through ``layers`` and the final norm ``gamma``, the stream
    sequence-sharded over a model group where the flags and its length
    allow -> (hidden states, sequence-sharded?)."""
    cfg, ctx = model.cfg, model_ctx(model)
    h, sp = residual_in(h, ctx)
    h = _layers(fn, h, layers, cfg, *args, ctx, sp)
    return rms_norm(h, _gam(ctx, sp)(gamma), cfg.norm_eps), sp


def encode(model: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, n_frames, d) precomputed embeddings (frontend stub)."""
    h = frames.to(dt(model.cfg.compute_dtype))
    positions = torch.arange(h.shape[1], device=h.device)
    h, sp = _stream(model, _enc_layer, h, model.enc, model.enc_norm,
                    positions)
    return C.gather_from(h, 1, model_ctx(model).tp_group) if sp else h


def _decode_train(model: EncDec, enc_out, tokens):
    h = _embed(model, tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    return _stream(model, _dec_layer, h, model.dec, model.dec_norm,
                   positions, enc_out)


def decode_train(model: EncDec, enc_out: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The decoder over a whole token sequence -> final hidden states."""
    h, sp = _decode_train(model, enc_out, tokens)
    return C.gather_from(h, 1, model_ctx(model).tp_group) if sp else h


def logits_from_h(model: EncDec, h: torch.Tensor) -> torch.Tensor:
    """float32 logits against the tied embedding (every column)."""
    return gather_vocab(model, vocab_logits(model, model.embed.t(), h))


def loss_fn(model: EncDec, batch: dict, *, z_weight: float = 1e-4,
            group=None):
    """batch: {"frontend_embeds" (B, n_frames, d), "tokens" (B, S),
    "labels" (B, S)[, "weights"]} -> (total loss, {"loss", "z_loss"}).
    A data-parallel ``group`` as in ``lm.loss_fn``."""
    ctx = model_ctx(model)
    enc_out = encode(model, batch["frontend_embeds"])
    h, sp = _decode_train(model, enc_out, batch["tokens"])
    loss, z_loss = sharded_xent(
        vocab_logits(model, model.embed.t(), h, sp=sp), batch["labels"],
        batch.get("weights"), group, None if ctx is None else ctx.tp_group)
    total = loss + z_weight * z_loss
    if group is not None:
        loss = all_reduce_(loss.detach().clone(), group)
        z_loss = all_reduce_(z_loss.detach().clone(), group)
    return total, {"loss": loss, "z_loss": z_loss}


# ----------------------------------------------------------------- decoding

def init_cache(cfg: EncDecCfg, B: int, max_len: int,
               device: "str | torch.device" = "cuda", ctx=None
               ) -> list[dict]:
    """Per decoder layer: self-attention K/V over ``max_len`` slots (this
    rank's share with a model group in ``ctx``) and the cross-attention
    K/V of the ``n_frames`` encoder frames."""
    return _cache(cfg, B, max_len, resolve_device(device), ctx)


def abstract_cache(cfg: EncDecCfg, B: int, max_len: int) -> list[dict]:
    """:func:`init_cache`'s layout on ``meta`` tensors."""
    return _cache(cfg, B, max_len, torch.device("meta"))


def _cache(cfg: EncDecCfg, B: int, max_len: int, dev, ctx=None
           ) -> list[dict]:
    dtype = dt(cfg.param_dtype)
    n = 1 if ctx is None or ctx.tp_group is None else ctx.tp_size
    kv = (B, slots(_BLK, max_len, n), cfg.n_kv_heads, cfg.head_dim)
    xv = (B, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim)
    z = lambda shape: torch.zeros(shape, dtype=dtype, device=dev)
    return [{"k": z(kv), "v": z(kv), "xk": z(xv), "xv": z(xv)}
            for _ in range(cfg.n_dec_layers)]


def cache_spec(cfg: EncDecCfg, ctx) -> list[dict]:
    """Sharding specs of the decode cache (``distributed.sharding``), one
    dict per decoder layer as :func:`init_cache` lays it out: the self-
    attention KV sequence over `model`; the cross K/V span the fixed
    encoder frames (not 16-divisible, and small) and are replicated over
    `model`.  The JAX package's specs less its stacked layer axis."""
    dp = ctx.dp_spec
    s = (dp, ctx.tp, None, None)        # (B, S, K, hd): S over model
    x = (dp, None, None, None)
    return [{"k": s, "v": s, "xk": x, "xv": x}
            for _ in range(cfg.n_dec_layers)]


def precompute_cross_cache(model: EncDec, enc_out: torch.Tensor,
                           cache: list[dict]) -> list[dict]:
    """Fill each layer's cross-attention K/V from the encoder output
    (every head: gathered over a model group)."""
    ctx = model_ctx(model)
    g = None if ctx is None else ctx.tp_group
    dim = 2 if g is None or model.cfg.n_kv_heads % ctx.tp_size == 0 else 3
    out = []
    for p, c in zip(model.dec, cache):
        xk = C.gather_from(torch.einsum("bsd,dhk->bshk", enc_out,
                                        p.xattn.wk), dim, g)
        xv = C.gather_from(torch.einsum("bsd,dhk->bshk", enc_out,
                                        p.xattn.wv), dim, g)
        out.append({**c, "xk": xk.to(c["xk"].dtype),
                    "xv": xv.to(c["xv"].dtype)})
    return out


def decode_step(model: EncDec, tokens: torch.Tensor, cache: list[dict],
                pos: int):
    """One decoder token against the self-attention cache (updated in
    place) and the precomputed cross K/V.  Returns (logits (B, V),
    cache)."""
    cfg, ctx = model.cfg, model_ctx(model)
    mc = cfg.mc
    kw = {} if ctx is None else {"ctx": ctx}
    h = _embed(model, tokens)
    for p, c in zip(model.dec, cache):
        x = rms_norm(h, p.norm1, cfg.norm_eps)
        y, _, _ = attention_decode(x, p.attn, _BLK, mc, cache_k=c["k"],
                                   cache_v=c["v"], pos=pos, **kw)
        h = h + y
        x = rms_norm(h, p.norm_x, cfg.norm_eps)
        y, _, _ = attention_decode(x, p.xattn, _BLK, mc, cache_k=c["xk"],
                                   cache_v=c["xv"], pos=pos, cross=True,
                                   **kw)
        h = h + y
        x = rms_norm(h, p.norm2, cfg.norm_eps)
        h = h + mlp(x, p.mlp, mc, **kw)
    h = rms_norm(h, model.dec_norm, cfg.norm_eps)
    return logits_from_h(model, h)[:, 0], cache
