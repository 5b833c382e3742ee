"""pixtral-12b [vlm] — Pixtral-ViT + Mistral-Nemo backbone.
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128
[hf:mistralai/Pixtral-12B-2409; unverified].  The ViT patch frontend is a
stub: 256 precomputed patch embeddings per sample are prepended to the
token embeddings.
"""

from repro_torch.configs.shapes import FULL_ATTN_SHAPES
from repro_torch.models.common import BlockCfg, ModelCfg

ARCH_ID = "pixtral-12b"

CONFIG = ModelCfg(
    name=ARCH_ID,
    d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    vocab_size=131_072,
    pattern=(BlockCfg(kind="attn", d_ff=14_336),), n_repeats=40,
    act_fn="silu", rope_theta=1e6,
    frontend="patches", frontend_tokens=256,
)

SHAPES = FULL_ATTN_SHAPES


def smoke() -> ModelCfg:
    return ModelCfg(
        name="pixtral-smoke", d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab_size=512,
        pattern=(BlockCfg(kind="attn", d_ff=128),), n_repeats=2,
        act_fn="silu", rope_theta=1e6, frontend="patches", frontend_tokens=4,
        param_dtype="float32", compute_dtype="float32")
