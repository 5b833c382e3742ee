"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192.
[hf:ibm-granite/granite-3.0-2b-base; hf].  Logical vocab 49,155 padded to
49,408 (multiple of 256).  Tied embeddings, SwiGLU.
"""

from repro_torch.configs.shapes import FULL_ATTN_SHAPES
from repro_torch.models.common import BlockCfg, ModelCfg

ARCH_ID = "granite-3-2b"

CONFIG = ModelCfg(
    name=ARCH_ID,
    d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    vocab_size=49_408,
    pattern=(BlockCfg(kind="attn", d_ff=8192),), n_repeats=40,
    act_fn="silu", rope_theta=10_000.0, tie_embeddings=True,
)

SHAPES = FULL_ATTN_SHAPES


def smoke() -> ModelCfg:
    return ModelCfg(
        name="granite-smoke", d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab_size=512,
        pattern=(BlockCfg(kind="attn", d_ff=128),), n_repeats=2,
        act_fn="silu", tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32")
