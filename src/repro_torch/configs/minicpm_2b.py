"""minicpm-2b [dense] — 40L d_model=2304 36H (MHA kv=36) d_ff=5760.
[arXiv:2404.06395; hf].  Llama-like architecture.  Logical vocab 122,753
padded to 122,880 (multiple of 256).
"""

from repro_torch.configs.shapes import FULL_ATTN_SHAPES
from repro_torch.models.common import BlockCfg, ModelCfg

ARCH_ID = "minicpm-2b"

CONFIG = ModelCfg(
    name=ARCH_ID,
    d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    vocab_size=122_880,
    pattern=(BlockCfg(kind="attn", d_ff=5760),), n_repeats=40,
    act_fn="silu", rope_theta=10_000.0, tie_embeddings=True,
)

SHAPES = FULL_ATTN_SHAPES


def smoke() -> ModelCfg:
    return ModelCfg(
        name="minicpm-smoke", d_model=48, n_heads=6, n_kv_heads=6,
        head_dim=8, vocab_size=512,
        pattern=(BlockCfg(kind="attn", d_ff=96),), n_repeats=2,
        act_fn="silu", tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32")
