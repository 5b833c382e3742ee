"""mamba2-1.3b [ssm] — 48L d_model=2048 attention-free, ssm_state=128.
[arXiv:2405.21060; unverified].  SSD (state-space duality) mixer,
d_inner=4096, 64 heads x head_dim 64, no MLP (pure Mamba-2 block).
Logical vocab 50,280 padded to 50,432.
"""

from repro_torch.configs.shapes import SUBQUAD_SHAPES
from repro_torch.models.common import BlockCfg, ModelCfg, SSDCfg

ARCH_ID = "mamba2-1.3b"

_SSD = SSDCfg(d_inner=4096, head_dim=64, d_state=128, n_groups=1, chunk=256)

CONFIG = ModelCfg(
    name=ARCH_ID,
    d_model=2048, n_heads=1, n_kv_heads=1, head_dim=1,    # attn-free
    vocab_size=50_432,
    pattern=(BlockCfg(kind="ssd", ssd=_SSD),), n_repeats=48,
    act_fn="silu",
)

SHAPES = SUBQUAD_SHAPES


def smoke() -> ModelCfg:
    ssd = SSDCfg(d_inner=64, head_dim=16, d_state=16, n_groups=1, chunk=8)
    return ModelCfg(
        name="mamba2-smoke", d_model=32, n_heads=1, n_kv_heads=1, head_dim=1,
        vocab_size=256,
        pattern=(BlockCfg(kind="ssd", ssd=ssd),), n_repeats=2,
        act_fn="silu", param_dtype="float32", compute_dtype="float32")
