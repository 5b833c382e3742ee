"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920.
[arXiv:2404.14219; unverified].  RoPE + SwiGLU + GQA, vocab 100,352.
"""

from repro_torch.configs.shapes import FULL_ATTN_SHAPES
from repro_torch.models.common import BlockCfg, ModelCfg

ARCH_ID = "phi3-medium-14b"

CONFIG = ModelCfg(
    name=ARCH_ID,
    d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    vocab_size=100_352,
    pattern=(BlockCfg(kind="attn", d_ff=17_920),), n_repeats=40,
    act_fn="silu", rope_theta=10_000.0,
)

SHAPES = FULL_ATTN_SHAPES


def smoke() -> ModelCfg:
    return ModelCfg(
        name="phi3-smoke", d_model=40, n_heads=5, n_kv_heads=5,
        head_dim=8, vocab_size=512,
        pattern=(BlockCfg(kind="attn", d_ff=96),), n_repeats=2,
        act_fn="silu", param_dtype="float32", compute_dtype="float32")
