"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680.
[arXiv:2402.19427; hf].  Griffin-style: RG-LRU recurrent blocks + local
(2048-window) MQA attention in a 2:1 ratio — pattern (rec, rec, attn) x 8
with a (rec, rec) prefix = 26 layers.  head_dim=256, d_rnn=2560,
vocab=256,000, tied + scaled embeddings, GeGLU.
"""

from repro_torch.configs.shapes import SUBQUAD_SHAPES
from repro_torch.models.common import BlockCfg, ModelCfg, RGLRUCfg

ARCH_ID = "recurrentgemma-2b"

_RG = RGLRUCfg(d_rnn=2560, d_conv=4)
_REC = BlockCfg(kind="rglru", d_ff=7680, rglru=_RG)
_ATT = BlockCfg(kind="attn", d_ff=7680, window=2048)

CONFIG = ModelCfg(
    name=ARCH_ID,
    d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    vocab_size=256_000,
    prefix=(_REC, _REC),
    pattern=(_REC, _REC, _ATT), n_repeats=8,
    act_fn="gelu", rope_theta=10_000.0, tie_embeddings=True, emb_scale=True,
)

SHAPES = SUBQUAD_SHAPES


def smoke() -> ModelCfg:
    rg = RGLRUCfg(d_rnn=48, d_conv=4)
    rec = BlockCfg(kind="rglru", d_ff=96, rglru=rg)
    att = BlockCfg(kind="attn", d_ff=96, window=8)
    return ModelCfg(
        name="rg-smoke", d_model=48, n_heads=4, n_kv_heads=1, head_dim=12,
        vocab_size=256, prefix=(rec,), pattern=(rec, rec, att), n_repeats=2,
        act_fn="gelu", tie_embeddings=True, emb_scale=True,
        param_dtype="float32", compute_dtype="float32")
