"""The model stack on one device: the configuration dataclasses
(:mod:`.common`), the layers (:mod:`.layers`), mixture-of-experts
(:mod:`.moe`), the decoder-only LM (:mod:`.lm`) and the encoder-decoder
(:mod:`.encdec`)."""

from repro_torch.models import common, encdec, layers, lm, moe
from repro_torch.models.common import (BlockCfg, ModelCfg, MoECfg, RGLRUCfg,
                                       SSDCfg)

__all__ = ["BlockCfg", "ModelCfg", "MoECfg", "RGLRUCfg", "SSDCfg", "common",
           "encdec", "layers", "lm", "moe"]
