"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16), MoE 64e top-8.
[arXiv:2409.02060; hf].  64 experts top-8, per-expert d_ff=1024, QK-norm,
vocab 50,304, head_dim=128.
"""

from repro_torch.configs.shapes import FULL_ATTN_SHAPES
from repro_torch.models.common import BlockCfg, ModelCfg, MoECfg

ARCH_ID = "olmoe-1b-7b"

_MOE = MoECfg(n_experts=64, top_k=8, d_ff=1024, capacity_factor=1.25)

CONFIG = ModelCfg(
    name=ARCH_ID,
    d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    vocab_size=50_304,
    pattern=(BlockCfg(kind="attn", moe=_MOE),), n_repeats=16,
    act_fn="silu", rope_theta=10_000.0, qk_norm=True,
)

SHAPES = FULL_ATTN_SHAPES


def smoke() -> ModelCfg:
    moe = MoECfg(n_experts=8, top_k=2, d_ff=64, capacity_factor=2.0)
    return ModelCfg(
        name="olmoe-smoke", d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        vocab_size=512,
        pattern=(BlockCfg(kind="attn", moe=moe),), n_repeats=2,
        act_fn="silu", qk_norm=True,
        param_dtype="float32", compute_dtype="float32")
