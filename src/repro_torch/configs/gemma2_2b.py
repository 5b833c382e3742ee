"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
[arXiv:2408.00118; hf].  Local(4096-window)/global alternating attention,
attention-logit softcap 50, final-logit softcap 30, post-block RMSNorms,
tied embeddings, sqrt(d) embedding scaling, GeGLU MLP, head_dim=256.
"""

from repro_torch.configs.shapes import FULL_ATTN_SHAPES
from repro_torch.models.common import BlockCfg, ModelCfg

ARCH_ID = "gemma2-2b"

CONFIG = ModelCfg(
    name=ARCH_ID,
    d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    vocab_size=256_000,
    pattern=(BlockCfg(kind="attn", d_ff=9216, window=4096, post_norms=True),
             BlockCfg(kind="attn", d_ff=9216, post_norms=True)),
    n_repeats=13,
    act_fn="gelu", rope_theta=10_000.0, tie_embeddings=True, emb_scale=True,
    attn_softcap=50.0, final_softcap=30.0,
)

SHAPES = FULL_ATTN_SHAPES


def smoke() -> ModelCfg:
    return ModelCfg(
        name="gemma2-smoke", d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab_size=512,
        pattern=(BlockCfg(kind="attn", d_ff=128, window=8, post_norms=True),
                 BlockCfg(kind="attn", d_ff=128, post_norms=True)),
        n_repeats=2, act_fn="gelu", tie_embeddings=True, emb_scale=True,
        attn_softcap=50.0, final_softcap=30.0,
        param_dtype="float32", compute_dtype="float32")
