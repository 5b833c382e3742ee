"""whisper-base [audio] — enc-dec, 6+6L d_model=512 8H d_ff=2048.
[arXiv:2212.04356; unverified].  The conv/log-mel frontend is a stub: the
encoder sees 1500 precomputed frame embeddings.  Logical vocab 51,865
padded to 52,224.  The decoder's published context (``n_text_ctx``) is 448.
"""

from repro_torch.configs.shapes import FULL_ATTN_SHAPES
from repro_torch.models.encdec import EncDecCfg

ARCH_ID = "whisper-base"

CONFIG = EncDecCfg(
    name=ARCH_ID,
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    vocab_size=52_224, d_ff=2048,
    n_enc_layers=6, n_dec_layers=6, n_frames=1500,
    act_fn="gelu",
)

SHAPES = FULL_ATTN_SHAPES


def smoke() -> EncDecCfg:
    return EncDecCfg(
        name="whisper-smoke", d_model=32, n_heads=4, n_kv_heads=4,
        head_dim=8, vocab_size=256, d_ff=64,
        n_enc_layers=2, n_dec_layers=2, n_frames=12, act_fn="gelu",
        param_dtype="float32", compute_dtype="float32")
