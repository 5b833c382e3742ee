"""The model stack's layers on one device (PyTorch port).

Each block kind is a module holding its parameters in the JAX package's
layouts (``wq`` is (d, H, hd), ``wo`` (H, hd, d), the MLP ``wi``/``wg``/
``wo``), and the computation is a function of (activations, module), with
the JAX package's names: :func:`rms_norm`, :func:`rope`, :func:`softcap`,
:func:`attention`, :func:`attention_decode`, :func:`mlp`,
:func:`ssd_mixer`, :func:`rglru_mixer`.  Nothing here constrains a
sharding: over a model group each function runs its collectives itself.

**Tensor parallelism.**  Every function takes ``ctx``, a
``distributed.sharding.ShardCtx`` whose ``tp_group`` is the model group
of a model placed by ``sharding.shard_params`` (``None``, or a context
without a group: the one-device path, unchanged), and ``sp``: the
residual stream arrives and leaves sequence-sharded (Megatron-SP,
``ShardCtx.seq_sharded``).  Each function is one Megatron region: its
input enters through ``collectives.copy_to`` (``all_gather`` over the
sequence under ``sp``), its row-parallel output leaves through ``psum``
(``reduce_scatter``).  Attention shards its heads when the head count
divides the group (branch a), gathers K and V over head_dim when only
the KV head count does not (branch b: the reference's head_dim-sharded
``wk``/``wv``), and runs context-parallel otherwise (branch c: queries
sequence-sharded through an all-to-all, K and V gathered, masks and
RoPE at the queries' global positions).  Replicated leaves used on this
rank's heads or channels (``q_gamma``, SSD's ``in_bc``, ``in_dt``,
``conv_w``, ``A_log``, ``D``, ``dt_bias``) pass through ``copy_to`` at
their use, so that every leaf's gradient is whole on every rank.  Decode
reads a cache whose slots are split over the group (flash-decoding):
each rank attends over its slots, and the shards meet in one max and two
sum all-reduces, weighted so that one rank computes the bits of the path
without a group.

The float32 places of the reference are kept: attention scores are
float32 products of the (possibly bfloat16) operands, and ``rms_norm``,
``rope`` and ``softcap`` compute in float32 and round back.  Scores are
scaled by ``1 / sqrt(hd)`` as a float32 product, as XLA compiles a
division by a constant (and as CUDA divides a tensor by a Python scalar).

Training differentiates these functions with autograd (the reference's
``jax.value_and_grad``).  The serving and training paths reach no Pallas
kernel in the reference, so nothing here launches a kernel of
:mod:`repro_torch.kernels`.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.distributed import collectives as C
from repro_torch.models.common import BlockCfg, ModelCfg, RGLRUCfg, SSDCfg

# --------------------------------------------------------------------------
# dtype / parameter helpers
# --------------------------------------------------------------------------

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


# leaves are drawn in chunks of this many elements: one chunk's draw
# peaks at 94 bytes an element on an H100 (chip_smoke.py, phase K)
INIT_CHUNK = 1 << 24


class KeyGen:
    """The reference's per-leaf key derivation: the n-th call returns
    ``fold_in(key, n)``, n from 1 (as key words).  ``key`` is a
    ``prng.PRNGKey``; an ``int`` is read as ``prng.PRNGKey(key)``."""

    def __init__(self, key):
        self.key = prng._words(prng.PRNGKey(key) if isinstance(key, int)
                               else key)
        self.n = 0

    def __call__(self) -> tuple[int, int]:
        self.n += 1
        return prng.fold_in_words(self.key, self.n)


@torch.no_grad()
def _init(t: torch.Tensor, key, fan_in: int, start: int = 0) -> None:
    """Fill ``t`` with the reference's ``_init``: ``truncated_normal(key,
    -2, 2)`` in float32 times the float32 rounding of ``1 /
    sqrt(fan_in)``, rounded once to ``t``'s dtype.  ``t`` takes the flat
    draw's elements from ``start`` on (a slice of a larger leaf), drawn
    ``INIT_CHUNK`` elements at a time on ``t``'s device."""
    scale = torch.tensor(1.0 / math.sqrt(max(fan_in, 1)),
                         dtype=torch.float32, device=t.device)
    flat = t.view(-1)
    for s in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - s)
        draw = prng.truncated_normal(key, -2.0, 2.0, (n,), t.device,
                                     start + s)
        flat[s:s + n] = (draw * scale).to(t.dtype)


class Params(nn.Module):
    """A parameter container: weights drawn by :meth:`reset_parameters`
    (each with its fan-in) and constant leaves set at construction."""

    def __init__(self, dtype: torch.dtype, device):
        super().__init__()
        self._dtype, self._device = dtype, device
        self._fan_in: dict[str, int] = {}

    def weight(self, name: str, shape, fan_in: int,
               dtype: Optional[torch.dtype] = None) -> None:
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype or self._dtype,
                        device=self._device), requires_grad=False))
        self._fan_in[name] = fan_in

    def const(self, name: str, value, dtype: Optional[torch.dtype] = None
              ) -> None:
        self.register_parameter(name, nn.Parameter(
            torch.as_tensor(value, dtype=dtype or self._dtype).to(
                self._device), requires_grad=False))

    def weights(self):
        """``(path, tensor, fan_in)`` of the weights in the reference's
        call order: this container's, in the order they were declared,
        then its child containers' in theirs.  Constant leaves are not
        weights."""
        for name, fan_in in self._fan_in.items():
            yield name, getattr(self, name), fan_in
        for cname, child in self.named_children():
            if isinstance(child, Params):
                for name, t, fan_in in child.weights():
                    yield f"{cname}.{name}", t, fan_in

    def reset_parameters(self, kg: KeyGen) -> None:
        """Draw the weights in :meth:`weights` order, one key of ``kg``
        each."""
        for _, t, fan_in in self.weights():
            _init(t, kg(), fan_in)


@torch.no_grad()
def load_tree(module: nn.Module, tree: dict) -> None:
    """Copy a nested dict of arrays (the reference's parameter tree, as
    numpy) into ``module``'s parameters of the same names.  Every value
    goes through float32, which holds bfloat16 exactly."""
    for name, value in tree.items():
        if isinstance(value, dict):
            load_tree(getattr(module, name), value)
            continue
        dst = getattr(module, name)
        src = torch.from_numpy(np.array(value, np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} against "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)


def module_tree(module: nn.Module) -> dict:
    """``module``'s parameters as the reference's nested dict: each
    parameter and each child module by its attribute name."""
    tree: dict = dict(module.named_parameters(recurse=False))
    tree.update((name, module_tree(child))
                for name, child in module.named_children())
    return tree


def stacked_layout(modules) -> dict:
    """The reference's subtree of same-shaped ``modules`` stacked on a
    leading axis, each leaf the tuple of the modules' parameters of that
    name (a parameter layout, see ``lm.param_layout``)."""
    def zip_trees(trees):
        return {k: zip_trees([t[k] for t in trees])
                if isinstance(v, dict) else tuple(t[k] for t in trees)
                for k, v in trees[0].items()}
    return zip_trees([module_tree(m) for m in modules])


def map_layout(fn, layout: dict) -> dict:
    """``fn`` over the leaves of a parameter layout: each a parameter, or
    the tuple of the parameters of a stacked leaf."""
    return {k: map_layout(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in layout.items()}


def layout_to_numpy(layout: dict) -> dict:
    """The values of a parameter layout as float32 numpy arrays, stacked
    leaves stacked on their leading axis (bfloat16 widens exactly)."""
    def one(x):
        t = torch.stack(x) if isinstance(x, tuple) else x
        return t.detach().float().cpu().numpy()
    return map_layout(one, layout)


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)`` with a backward: autograd has
    no derivative for that overload (``aten::mm.dtype``).

    JAX transposes the reference's ``preferred_element_type=float32``
    einsum into a product of the float32 cotangent with the other operand
    computed in float32, then converts it to the operand's dtype
    (``dot_general``'s transpose rule); the backward here computes the
    same, as the CPU branch of :func:`matmul_f32` does through
    autograd."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().t() @ g).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with float32 output (the reference's
    ``preferred_element_type=float32``) without a float32 copy of ``b``:
    on CUDA a bfloat16 product accumulates and returns float32.  ``meta``
    tensors (the dry-run's) take the card's branch, so that their op
    counts are the card's."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda or a.is_meta:
        return _MatmulF32.apply(a, b)
    return a.float() @ b.float()


# --------------------------------------------------------------------------
# Tensor-parallel regions
# --------------------------------------------------------------------------

def model_ctx(model):
    """The context ``sharding.shard_params`` recorded on ``model`` when it
    has a model group, else None (the path without collectives)."""
    ctx = getattr(model, "shard_ctx", None)
    return ctx if ctx is not None and ctx.tp_group is not None else None


def _group(ctx):
    return None if ctx is None else ctx.tp_group


def _enter(x: torch.Tensor, g, sp: bool) -> torch.Tensor:
    """The block input into this rank's region: the replicated residual
    through ``copy_to``, the sequence-sharded one gathered."""
    return C.all_gather(x, 1, g) if sp else C.copy_to(x, g)


def _leave(y: torch.Tensor, g, sp: bool) -> torch.Tensor:
    """The ranks' partial outputs summed (and sequence-sharded)."""
    return C.reduce_scatter(y, 1, g) if sp else C.psum(y, g)


def _local_groups(t: torch.Tensor, dim: int, first: int, count: int,
                  per: int) -> torch.Tensor:
    """The entries along ``dim`` that ``count`` consecutive heads from
    ``first`` read when ``per`` heads share one (GQA's KV heads, SSD's
    B/C groups): whole groups, one group, or one entry a head."""
    if count % per == 0:
        return t.narrow(dim, first // per, count // per)
    if per % count == 0:
        return t.narrow(dim, first // per, 1)
    idx = torch.arange(first, first + count, device=t.device) // per
    return t.index_select(dim, idx)


# --------------------------------------------------------------------------
# Norms and positional embeddings
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def _rms_norm_tp(x: torch.Tensor, gamma: torch.Tensor, eps: float, g
                 ) -> torch.Tensor:
    """:func:`rms_norm` of a tensor whose last dim is split over ``g``
    (``gamma`` this rank's block): the mean of squares is the mean of the
    ranks' means (equal blocks)."""
    xf = x.float()
    var = C.copy_to(C.psum(xf.square().mean(-1, keepdim=True), g), g) \
        * (1.0 / C.group_size(g))
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    angles = positions[..., None].float() * freqs       # (..., S, hd/2)
    angles = angles[..., None, :]                       # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


ACTS: dict[str, Callable] = {
    "silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

class Attention(Params):
    """Self- or cross-attention projections (GQA)."""

    def __init__(self, cfg: ModelCfg, dtype, device):
        super().__init__(dtype, device)
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.weight("wq", (d, H, hd), d)
        self.weight("wk", (d, K, hd), d)
        self.weight("wv", (d, K, hd), d)
        self.weight("wo", (H, hd, d), cfg.q_dim)
        if cfg.qk_norm:
            self.const("q_gamma", torch.zeros(hd))
            self.const("k_gamma", torch.zeros(hd))


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor,
               window: Optional[int], *, causal: bool = True
               ) -> torch.Tensor:
    """(..., Sq, Skv) additive mask bias in float32."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    ok = (d >= 0) if causal else torch.ones_like(d, dtype=torch.bool)
    if window is not None:
        ok = ok & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def _inv_sqrt(hd: int) -> float:
    """``1 / sqrt(hd)`` as XLA folds the division by ``sqrt(hd)``: the
    float32 reciprocal of the float32 root."""
    return float(np.float32(1.0) / np.float32(math.sqrt(hd)))


def _scores(q: torch.Tensor, k: torch.Tensor, spec: str, hd: int
            ) -> torch.Tensor:
    """float32 ``q . k`` over ``spec`` scaled by ``1 / sqrt(hd)`` (the
    reference's ``preferred_element_type=float32``: bfloat16 products are
    exact in float32)."""
    return torch.einsum(spec, q.float(), k.float()) * _inv_sqrt(hd)


def _sdpa(q, k, v, bias, cfg: ModelCfg):
    """Grouped-query attention core. q:(B,Sq,H,hd) k/v:(B,Skv,K,hd)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    scores = _scores(qg, k, "bqkgh,bskh->bkgqs", hd)
    scores = softcap(scores, cfg.attn_softcap)
    scores = scores + (bias[..., None, None, :, :] if bias.ndim == 2
                       else bias)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def _chunked_sdpa(q, k, v, q_pos, kv_pos, window, cfg: ModelCfg,
                  kv_chunk: int = 1024, causal: bool = True):
    """Online-softmax attention over KV chunks of ``kv_chunk`` keys,
    carrying the running (max, denominator, accumulator): the score
    matrix stays at (B, K, G, Sq, kv_chunk)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd).float() * _inv_sqrt(hd)
    m = torch.full((B, K, G, Sq), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, k.shape[1], kv_chunk):
        kb = k[:, c0:c0 + kv_chunk].float()
        vb = v[:, c0:c0 + kv_chunk].float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kb)
        s = softcap(s, cfg.attn_softcap)
        s = s + _mask_bias(q_pos, kv_pos[c0:c0 + kv_chunk], window,
                           causal=causal)[None, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bkgqs,bskh->bkgqh",
                                                    p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4)                   # (B,Sq,K,G,hd)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def score_cols(skv: int) -> int:
    """The key columns of one score block of :func:`attention` over
    ``skv`` keys: past 4096 keys (a multiple of 1024) it runs
    :func:`_chunked_sdpa` over 1024-key chunks."""
    return 1024 if skv > 4096 and skv % 1024 == 0 else skv


def _attend(q, k, v, q_pos, kv_pos, blk: BlockCfg, cfg: ModelCfg,
            causal: bool):
    if score_cols(k.shape[1]) != k.shape[1]:
        return _chunked_sdpa(q, k, v, q_pos, kv_pos, blk.window, cfg,
                             causal=causal)
    bias = _mask_bias(q_pos, kv_pos, blk.window, causal=causal)
    return _sdpa(q, k, v, bias, cfg)


def attention(x: torch.Tensor, p: Attention, blk: BlockCfg, cfg: ModelCfg,
              *, positions: torch.Tensor, causal: bool = True,
              xkv: Optional[torch.Tensor] = None, return_kv: bool = False,
              ctx=None, sp: bool = False):
    """Full-sequence attention (prefill).  ``xkv`` switches to
    cross-attention (no RoPE).  ``return_kv`` also returns the rotary-
    embedded (k, v) for the prefill cache, every head; window blocks
    keep the last ``window`` positions.  ``ctx``, ``sp``: tensor
    parallelism (module docstring)."""
    g = _group(ctx)
    n, r = C.group_size(g), C.group_rank(g)
    H, K = cfg.n_heads, cfg.n_kv_heads
    head_tp, kv_tp = H % n == 0, K % n == 0
    xs = _enter(x, g, sp)
    # cross-attention: one node for the K and V projections' reads (their
    # cotangents meet there first, with or without a group)
    kv_src = xs if xkv is None else C.copy_to(xkv.view_as(xkv), g)
    q = torch.einsum("bsd,dhk->bshk", xs, p.wq)
    k = torch.einsum("bsd,dhk->bshk", kv_src, p.wk)
    v = torch.einsum("bsd,dhk->bshk", kv_src, p.wv)
    kv_pos = positions if xkv is None else torch.arange(
        kv_src.shape[1], device=x.device)
    S = q.shape[1]
    local = True                # the gammas meet this rank's heads / rows
    if head_tp:                 # (a), and (b) with K / V over head_dim
        q_pos = positions
        if not kv_tp:
            k, v = C.all_gather(k, 3, g), C.all_gather(v, 3, g)
    elif S % n == 0:            # (c) context parallel
        q = C.all_to_all_dims(q, 1, 3, g)
        k, v = C.all_gather(k, 3, g), C.all_gather(v, 3, g)
        q_pos = positions.narrow(0, r * (S // n), S // n)
    else:                       # (c) on a sequence the group does not divide
        q, k, v = (C.gather_from(t, 3, g) for t in (q, k, v))
        q_pos, local = positions, False
    if cfg.qk_norm:
        gam = (lambda t: C.copy_to(t, g)) if local else (lambda t: t)
        q = rms_norm(q, gam(p.q_gamma), cfg.norm_eps)
        k = rms_norm(k, gam(p.k_gamma), cfg.norm_eps)
    if blk.kind == "attn" and xkv is None:
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, kv_pos, cfg.rope_theta)

    if head_tp and not kv_tp:
        Hl = H // n
        kl = _local_groups(k, 2, r * Hl, Hl, H // K)
        vl = _local_groups(v, 2, r * Hl, Hl, H // K)
    else:
        kl, vl = k, v
    out = _attend(q, kl, vl, q_pos, kv_pos, blk, cfg, causal)
    if not head_tp:
        out = (C.all_to_all_dims(out, 3, 1, g) if local
               else C.scatter_to(out, 3, g))
    y = _leave(torch.einsum("bshk,hkd->bsd", out, p.wo), g, sp)
    if return_kv:
        if head_tp and kv_tp:
            k, v = C.gather_from(k, 2, g), C.gather_from(v, 2, g)
        if blk.window is not None and k.shape[1] > blk.window:
            k, v = k[:, -blk.window:], v[:, -blk.window:]
        return y, (k, v)
    return y


def attention_decode(x: torch.Tensor, p: Attention, blk: BlockCfg,
                     cfg: ModelCfg, *, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cross: bool = False,
                     ctx=None, sp: bool = False):
    """One-token decode against a (B, W, K, hd) cache.  x: (B, 1, d).

    Self-attention writes the new K/V at slot ``pos`` (``pos % W`` for a
    window block's ring) in place; a window block attends to the slots
    whose position ``kv_pos`` has ``0 <= pos - kv_pos < window``.
    ``cross`` attends to every slot of a precomputed encoder K/V.
    Returns (y, cache_k, cache_v).  With a model group in ``ctx`` every
    rank builds the whole query (and new K/V); the self-attention cache
    holds this rank's ``W / n`` slots of a ring of ``W``
    (``lm.init_cache``), attended and merged (module docstring); a
    cross-attention cache is whole on every rank."""
    g = _group(ctx)
    n, r = C.group_size(g), C.group_rank(g)
    H, K = cfg.n_heads, cfg.n_kv_heads
    head_tp, kv_tp = H % n == 0, K % n == 0
    xs = _enter(x, g, sp)
    q = C.gather_from(torch.einsum("bsd,dhk->bshk", xs, p.wq),
                      2 if head_tp else 3, g)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_gamma, cfg.norm_eps)
    Wl = cache_k.shape[1]
    idx = torch.arange(Wl, device=x.device)
    if cross:
        valid = torch.ones(Wl, dtype=torch.bool, device=x.device)
    else:
        kd = 2 if head_tp and kv_tp else 3
        k_new = C.gather_from(torch.einsum("bsd,dhk->bshk", xs, p.wk), kd, g)
        v_new = C.gather_from(torch.einsum("bsd,dhk->bshk", xs, p.wv), kd, g)
        if cfg.qk_norm:
            k_new = rms_norm(k_new, p.k_gamma, cfg.norm_eps)
        if blk.kind == "attn":
            # made on the device: a host tensor here would be a blocking copy
            where = torch.full((1,), pos, device=x.device)
            q = rope(q, where, cfg.rope_theta)
            k_new = rope(k_new, where, cfg.rope_theta)
        W = Wl * n              # the ring: this rank holds [r*Wl, (r+1)*Wl)
        slot = pos % W if blk.window is not None else pos
        if g is None or slot // Wl == r:
            cache_k[:, slot % Wl] = k_new[:, 0].to(cache_k.dtype)
            cache_v[:, slot % Wl] = v_new[:, 0].to(cache_v.dtype)
        if g is not None:
            idx = idx + r * Wl
        if blk.window is not None:
            # slot s holds the largest position p <= pos with p % W == s
            back = (pos - idx) % W
            valid = (pos - back >= 0) & (back < blk.window)
        else:
            valid = idx <= pos

    B, _, _, hd = q.shape
    qg = q.reshape(B, cache_k.shape[2], H // cache_k.shape[2], hd)
    s = _scores(qg, cache_k, "bkgh,bskh->bkgs", hd)
    s = softcap(s, cfg.attn_softcap)
    s = s.masked_fill(~valid, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w.to(cache_v.dtype), cache_v)
    if g is not None and not cross:
        # flash-decoding: this rank's softmax weighted by its share of the
        # whole normaliser, exp(lse_r - lse) (1 on one rank, exactly)
        lse = torch.logsumexp(s, dim=-1)
        top = C.pmax(lse, g)
        lse_all = torch.log(C.psum(torch.exp(lse - top), g)) + top
        c = torch.exp(lse - lse_all)
        out = C.psum(c[..., None] * out.float(), g).to(cache_v.dtype)
    out = out.reshape(B, 1, H, hd)
    if g is not None:
        out = (out.narrow(2, r * (H // n), H // n) if head_tp
               else out.narrow(3, r * (hd // n), hd // n))
    y = _leave(torch.einsum("bshk,hkd->bsd", out, p.wo), g, sp)
    return y, cache_k, cache_v


# --------------------------------------------------------------------------
# Dense MLP (gated)
# --------------------------------------------------------------------------

class MLP(Params):
    def __init__(self, d: int, d_ff: int, dtype, device):
        super().__init__(dtype, device)
        self.weight("wi", (d, d_ff), d)
        self.weight("wg", (d, d_ff), d)
        self.weight("wo", (d_ff, d), d_ff)


def mlp(x: torch.Tensor, p: MLP, cfg: ModelCfg, *, ctx=None,
        sp: bool = False) -> torch.Tensor:
    """Gated MLP; column then row parallel over a model group."""
    grp = _group(ctx)
    if grp is not None:
        x = _enter(x, grp, sp)
    h = x @ p.wi
    g = x @ p.wg
    y = (ACTS[cfg.act_fn](g) * h) @ p.wo
    return y if grp is None else _leave(y, grp, sp)


# --------------------------------------------------------------------------
# Mamba-2 SSD mixer (chunked matmul form)
# --------------------------------------------------------------------------

class SSD(Params):
    def __init__(self, cfg: ModelCfg, s: SSDCfg, dtype, device):
        super().__init__(dtype, device)
        d = cfg.d_model
        H = s.d_inner // s.head_dim
        conv_ch = s.d_inner + 2 * s.n_groups * s.d_state
        self.weight("in_xz", (d, 2 * s.d_inner), d)
        self.weight("in_bc", (d, 2 * s.n_groups * s.d_state), d)
        self.weight("in_dt", (d, H), d)
        self.weight("conv_w", (s.d_conv, conv_ch), s.d_conv)
        self.const("A_log", torch.zeros(H), torch.float32)
        self.const("D", torch.ones(H), torch.float32)
        self.const("dt_bias", torch.full((H,), math.log(math.e - 1)),
                   torch.float32)
        self.const("norm_g", torch.zeros(s.d_inner))
        self.weight("out", (s.d_inner, d), s.d_inner)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, conv_state=None):
    """Depthwise causal conv of (B, S, C) over the last ``d_conv`` inputs
    (``conv_state`` holds the previous ``d_conv - 1``; zeros at the start).
    Returns (conv out, the new state)."""
    d_conv = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], d_conv - 1, x.shape[2]))
    win = torch.cat([conv_state, x], dim=1)
    out = torch.einsum("bsct,tc->bsc", win.unfold(1, d_conv, 1), w)
    return out, (win[:, -(d_conv - 1):] if d_conv > 1 else None)


def _ssd_chunk_scan(xh, a_log_dt, Bm, Cm, chunk: int, init_state=None):
    """SSD (state-space duality) chunked scan.

    xh: (B,S,H,P) dt-scaled inputs, a_log_dt: (B,S,H) log decay, Bm/Cm:
    (B,S,G,N) input/output maps.  Returns (y (B,S,H,P), final state
    (B,H,P,N)).  Within a chunk: dense products; across chunks: the state
    carried chunk by chunk."""
    Bsz, S, H, Pd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    rep = H // G
    xc = xh.reshape(Bsz, nc, chunk, H, Pd)
    ac = a_log_dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    cum = torch.cumsum(ac, dim=2)                        # (B,nc,L,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Lq,Lk,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    L = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                    torch.zeros((), dtype=seg.dtype, device=seg.device))

    # intra-chunk (diagonal block): y_intra = (C B^T * L) @ x
    cb = torch.einsum("bnqhs,bnkhs->bnqkh", Cc, Bc)
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", cb * L, xc)

    # chunk-local state: sum_k exp(cum_end - cum_k) B_k x_k
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)    # (B,nc,L,H)
    chunk_states = torch.einsum("bnkhs,bnkhp->bnhps",
                                Bc * decay_to_end[..., None], xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B,nc,H)

    state = (torch.zeros((Bsz, H, Pd, N), dtype=xh.dtype, device=xh.device)
             if init_state is None else init_state)
    prev = []
    for n in range(nc):                                  # state before chunk n
        prev.append(state)
        state = state * chunk_decay[:, n, :, None, None] + chunk_states[:, n]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    # inter-chunk: y_inter = C_q exp(cum_q) @ state_in
    y_inter = torch.einsum("bnqhs,bnhps->bnqhp",
                           Cc * torch.exp(cum)[..., None], prev_states)
    return (y_intra + y_inter).reshape(Bsz, S, H, Pd), state


def ssd_mixer(x, p: SSD, s: SSDCfg, cfg: ModelCfg, *, conv_state=None,
              ssm_state=None, decode: bool = False, ctx=None,
              sp: bool = False):
    """Mamba-2 block.  Returns (out, new conv state, new SSM state).

    Over a model group each rank runs its block of heads (``x`` and ``z``
    channels of the fused ``in_xz``) with every B/C channel: its conv
    state holds its ``x`` channels then the B/C channels, its SSM state
    its heads."""
    g = _group(ctx)
    B = x.shape[0]
    H = s.d_inner // s.head_dim
    n, r = C.group_size(g), C.group_rank(g)
    di, Hl = s.d_inner // n, H // n
    if g is not None:
        x = _enter(x, g, sp)
    S = x.shape[1]
    # replicated leaves read on this rank's heads: whole gradients
    rep_ = (lambda t: t) if g is None else (lambda t: C.copy_to(t, g))
    xz = x @ p.in_xz
    bc = x @ rep_(p.in_bc)
    dtv = (x @ rep_(p.in_dt)).float()
    xi, z = xz.chunk(2, dim=-1)
    conv_w, dt_bias, A_log, D = p.conv_w, p.dt_bias, p.A_log, p.D
    if g is not None:
        conv_w = rep_(conv_w)
        conv_w = torch.cat([conv_w[:, r * di:(r + 1) * di],
                            conv_w[:, s.d_inner:]], dim=1)
        dtv = dtv[..., r * Hl:(r + 1) * Hl]
        dt_bias, A_log, D = (rep_(t)[r * Hl:(r + 1) * Hl]
                             for t in (dt_bias, A_log, D))
    conv_out, new_conv_state = _causal_conv(torch.cat([xi, bc], dim=-1),
                                            conv_w, conv_state)
    conv_out = F.silu(conv_out)
    xi = conv_out[..., :di]
    Bm, Cm = conv_out[..., di:].reshape(
        B, -1, 2 * s.n_groups, s.d_state).chunk(2, dim=2)
    if g is not None:
        per = H // s.n_groups
        Bm = _local_groups(Bm, 2, r * Hl, Hl, per)
        Cm = _local_groups(Cm, 2, r * Hl, Hl, per)

    dtv = F.softplus(dtv + dt_bias)
    a_log_dt = dtv * -torch.exp(A_log)                   # (B,S,H) log decay
    xi_h = xi.reshape(B, -1, Hl, s.head_dim).float()
    xh = xi_h * dtv[..., None]

    if decode:
        rep = Hl // Bm.shape[2]
        a = torch.exp(a_log_dt)[:, 0]                    # (B,H)
        st = ssm_state * a[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xh[:, 0],
            Bm[:, 0].repeat_interleave(rep, dim=1).float())
        y = torch.einsum("bhpn,bhn->bhp", st,
                         Cm[:, 0].repeat_interleave(rep, dim=1).float())
        y, new_ssm_state = y[:, None], st
    else:
        chunk = next(c for c in range(min(s.chunk, S), 0, -1) if S % c == 0)
        y, new_ssm_state = _ssd_chunk_scan(xh, a_log_dt, Bm.float(),
                                           Cm.float(), chunk,
                                           init_state=ssm_state)

    y = y + xi_h * D[:, None]                            # skip (D term)
    y = y.reshape(B, -1, di).to(x.dtype)
    y = y * F.silu(z)
    if g is None:
        y = rms_norm(y, p.norm_g, cfg.norm_eps)
        return y @ p.out, new_conv_state, new_ssm_state
    y = _rms_norm_tp(y, p.norm_g, cfg.norm_eps, g)
    return _leave(y @ p.out, g, sp), new_conv_state, new_ssm_state


# --------------------------------------------------------------------------
# RG-LRU mixer (RecurrentGemma)
# --------------------------------------------------------------------------

class RGLRU(Params):
    def __init__(self, cfg: ModelCfg, r: RGLRUCfg, dtype, device):
        super().__init__(dtype, device)
        d = cfg.d_model
        self.weight("in_xy", (d, 2 * r.d_rnn), d)
        self.weight("conv_w", (r.d_conv, r.d_rnn), r.d_conv)
        self.weight("w_r", (r.d_rnn, r.d_rnn), r.d_rnn)
        self.weight("w_i", (r.d_rnn, r.d_rnn), r.d_rnn)
        # a = sigmoid(a_param)^(c*r): a^c from 0.9 to 0.999
        self.const("a_param", np.log(np.expm1(
            np.linspace(0.9, 0.999, r.d_rnn) ** (1.0 / r.c_exponent))),
            torch.float32)
        self.weight("out", (r.d_rnn, d), r.d_rnn)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1 from ``h_{-1} = 0``, in
    ceil(log2 S) doubling steps (the combine of the reference's
    ``associative_scan``, applied in another order)."""
    S, off = a.shape[1], 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_mixer(x, p: RGLRU, r: RGLRUCfg, cfg: ModelCfg, *, conv_state=None,
                h_state=None, decode: bool = False, ctx=None,
                sp: bool = False):
    """Real-gated LRU: h_t = a_t*h_{t-1} + sqrt(1-a_t^2)*(i_t * x_t).
    Returns (out, new conv state, new h).  Over a model group each rank
    runs its block of channels; the gates' projections read every
    channel of the conv output, gathered."""
    g = _group(ctx)
    if g is not None:
        x = _enter(x, g, sp)
    xb, gate_y = (x @ p.in_xy).chunk(2, dim=-1)
    xc, new_conv_state = _causal_conv(xb, p.conv_w, conv_state)

    # one node for the gates' reads of xc (a no-op view without a group),
    # so that their gradients meet before the gated path's in both paths
    xc_all = xc.view_as(xc) if g is None else C.all_gather(xc, 2, g)
    rg = torch.sigmoid((xc_all @ p.w_r).float())
    ig = torch.sigmoid((xc_all @ p.w_i).float())
    log_a = r.c_exponent * rg * F.logsigmoid(p.a_param)  # (B,S,d_rnn)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * ig * xc.float()

    if decode:
        new_h = a[:, 0] * h_state + gated[:, 0]
        hs = new_h[:, None]
    else:
        if h_state is not None:
            gated = torch.cat([gated[:, :1] + (a[:, 0] * h_state)[:, None],
                               gated[:, 1:]], dim=1)
        hs = _linear_scan(a, gated)
        new_h = hs[:, -1]

    y = (hs.to(x.dtype) * F.gelu(gate_y, approximate="tanh")) @ p.out
    return (y if g is None else _leave(y, g, sp)), new_conv_state, new_h
