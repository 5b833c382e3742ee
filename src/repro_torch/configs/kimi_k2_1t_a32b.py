"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8), MoE 384e top-8.
[arXiv:2501.kimi2; unverified].  Trillion-parameter MoE: 1 dense lead-in
layer (d_ff=18432) + 60 MoE layers with 384 routed experts (per-expert
d_ff=2048, top-8) and 1 shared expert, vocab=163,840, head_dim=112
(64x112=7168).
"""

from repro_torch.configs.shapes import FULL_ATTN_SHAPES
from repro_torch.models.common import BlockCfg, ModelCfg, MoECfg

ARCH_ID = "kimi-k2-1t-a32b"

_MOE = MoECfg(n_experts=384, top_k=8, d_ff=2048, n_shared_experts=1,
              capacity_factor=1.25)

CONFIG = ModelCfg(
    name=ARCH_ID,
    d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    vocab_size=163_840,
    prefix=(BlockCfg(kind="attn", d_ff=18_432),),
    pattern=(BlockCfg(kind="attn", moe=_MOE),), n_repeats=60,
    act_fn="silu", rope_theta=50_000.0,
)

SHAPES = FULL_ATTN_SHAPES


def smoke() -> ModelCfg:
    moe = MoECfg(n_experts=8, top_k=2, d_ff=64, n_shared_experts=1,
                 capacity_factor=2.0)
    return ModelCfg(
        name="kimi-smoke", d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        vocab_size=512,
        prefix=(BlockCfg(kind="attn", d_ff=128),),
        pattern=(BlockCfg(kind="attn", moe=moe),), n_repeats=2,
        act_fn="silu", param_dtype="float32", compute_dtype="float32")
