"""Model configuration dataclasses shared by every registry architecture.

A decoder-only model is: embedding -> ``prefix`` blocks -> ``pattern``
blocks repeated ``n_repeats`` times -> ``suffix`` blocks -> final norm ->
LM head.  Each :class:`BlockCfg` describes one residual block: a mixer
(attention / RG-LRU / Mamba-2 SSD) followed by a channel MLP (dense or
MoE).  Heterogeneous layer patterns (gemma-2 local/global alternation,
recurrentgemma 1:2 recurrent:attention) are multi-block patterns.

Only the configurations live here: :mod:`.lm` runs them as models, and
the model-zoo frontend (:mod:`repro_torch.neuromorphic.frontend`) lowers
them onto the simulator.
``param_count`` / ``active_param_count`` are the closed forms the
frontend's parameter identity is checked against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    """Mixture-of-experts channel block (token-choice top-k)."""

    n_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden width
    capacity_factor: float = 1.25
    decode_capacity_factor: float = 4.0
    n_shared_experts: int = 0       # always-on experts (kimi-k2 style)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSDCfg:
    """Mamba-2 SSD mixer (state-space duality, chunked matmul form)."""

    d_inner: int
    head_dim: int = 64
    d_state: int = 128
    n_groups: int = 1
    chunk: int = 256
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class RGLRUCfg:
    """RG-LRU mixer (RecurrentGemma / Griffin real-gated linear recurrence)."""

    d_rnn: int
    d_conv: int = 4
    c_exponent: float = 8.0         # a = a_param^(c * r_gate)


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One residual block = mixer + channel MLP."""

    kind: str                       # "attn" | "ssd" | "rglru"
    d_ff: int = 0                   # dense MLP hidden width (0 = no MLP)
    moe: Optional[MoECfg] = None    # MoE replaces the dense MLP when set
    window: Optional[int] = None    # local (sliding-window) attention
    post_norms: bool = False        # gemma-2 style post-block RMSNorm
    ssd: Optional[SSDCfg] = None
    rglru: Optional[RGLRUCfg] = None


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Full decoder-only LM configuration (see encdec.py for whisper)."""

    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    prefix: tuple[BlockCfg, ...] = ()
    pattern: tuple[BlockCfg, ...] = ()
    n_repeats: int = 0
    suffix: tuple[BlockCfg, ...] = ()

    act_fn: str = "silu"            # "silu" | "gelu" | "relu"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    attn_softcap: Optional[float] = None     # gemma-2 logit soft-capping
    final_softcap: Optional[float] = None
    tie_embeddings: bool = False
    emb_scale: bool = False         # gemma-style sqrt(d_model) embed scaling
    qk_norm: bool = False

    # VLM / audio frontends are stubs: precomputed patch/frame embeddings
    # are concatenated before the first block.
    frontend: str = "none"          # "none" | "patches" | "frames"
    frontend_tokens: int = 0        # number of pre-embedded positions

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "block"            # "none" | "block"

    @property
    def n_layers(self) -> int:
        return (len(self.prefix) + len(self.pattern) * self.n_repeats
                + len(self.suffix))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def all_blocks(self) -> list[BlockCfg]:
        return (list(self.prefix) + list(self.pattern) * self.n_repeats
                + list(self.suffix))

    def param_count(self) -> int:
        """Exact parameter count (embeddings included once if tied)."""
        d = self.d_model
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += d                              # final norm
        for blk in self.all_blocks():
            total += d                          # mixer pre-norm
            if blk.moe is not None or blk.d_ff:
                total += d                      # mlp pre-norm
            if blk.post_norms:
                total += 2 * d
            if blk.kind == "attn":
                total += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                if self.qk_norm:
                    total += 2 * self.head_dim
            elif blk.kind == "ssd":
                s = blk.ssd
                h = s.d_inner // s.head_dim
                total += d * (2 * s.d_inner + 2 * s.n_groups * s.d_state + h)
                total += s.d_conv * (s.d_inner + 2 * s.n_groups * s.d_state)
                total += 3 * h                  # A_log, D, dt_bias
                total += s.d_inner              # gate norm
                total += s.d_inner * d
            elif blk.kind == "rglru":
                r = blk.rglru
                total += 2 * d * r.d_rnn        # in proj (x + gate)
                total += r.d_rnn * d            # out proj
                total += r.d_conv * r.d_rnn     # depthwise conv
                total += 2 * r.d_rnn * r.d_rnn  # r,i gates
                total += r.d_rnn                # a_param
            if blk.moe is not None:
                m = blk.moe
                total += d * m.n_experts        # router
                total += m.n_experts * 3 * d * m.d_ff
                total += m.n_shared_experts * 3 * d * m.d_ff
            elif blk.d_ff:
                total += 3 * d * blk.d_ff       # SwiGLU wi/wg/wo
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        total = self.param_count()
        for blk in self.all_blocks():
            if blk.moe is not None:
                m = blk.moe
                inactive = m.n_experts - m.top_k
                total -= inactive * 3 * self.d_model * m.d_ff
        return total


def dense_block(d_ff: int, *, window: int | None = None,
                post_norms: bool = False) -> BlockCfg:
    return BlockCfg(kind="attn", d_ff=d_ff, window=window,
                    post_norms=post_norms)


def moe_block(moe: MoECfg, *, window: int | None = None) -> BlockCfg:
    return BlockCfg(kind="attn", moe=moe, window=window)
