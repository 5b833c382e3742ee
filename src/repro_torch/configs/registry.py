"""Architecture registry: ``--arch <id>`` resolution for every launcher.

Each entry carries the exact assigned config, its shape cells (with the
long_500k skips applied per family), a reduced smoke config and the
abstract input specs of a cell; the model code that runs them is
:mod:`repro_torch.models`, the launchers :mod:`repro_torch.launch`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import (gemma2_2b, granite_3_2b, kimi_k2_1t_a32b,
                                 mamba2_1_3b, minicpm_2b, olmoe_1b_7b,
                                 phi3_medium_14b, pixtral_12b,
                                 recurrentgemma_2b, whisper_base)
from repro_torch.configs.shapes import (ShapeSpec, encdec_input_specs,
                                        lm_input_specs)
from repro_torch.models.encdec import EncDecCfg


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    config: object                    # ModelCfg | EncDecCfg
    shapes: dict[str, ShapeSpec]
    smoke: Callable[[], object]
    family: str

    @property
    def is_encdec(self) -> bool:
        return isinstance(self.config, EncDecCfg)

    def input_specs(self, shape: ShapeSpec, microbatch: int | None = None,
                    cfg=None):
        fn = encdec_input_specs if self.is_encdec else lm_input_specs
        return fn(cfg if cfg is not None else self.config, shape, microbatch)


_MODULES = {
    "vlm": [pixtral_12b],
    "dense": [minicpm_2b, gemma2_2b, granite_3_2b, phi3_medium_14b],
    "moe": [kimi_k2_1t_a32b, olmoe_1b_7b],
    "audio": [whisper_base],
    "ssm": [mamba2_1_3b],
    "hybrid": [recurrentgemma_2b],
}

REGISTRY: dict[str, ArchEntry] = {}
for family, mods in _MODULES.items():
    for mod in mods:
        REGISTRY[mod.ARCH_ID] = ArchEntry(
            arch_id=mod.ARCH_ID, config=mod.CONFIG, shapes=dict(mod.SHAPES),
            smoke=mod.smoke, family=family)

ARCH_IDS = sorted(REGISTRY)


def get(arch_id: str) -> ArchEntry:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return REGISTRY[arch_id]


def all_cells() -> list[tuple[str, str]]:
    """Every assigned (arch, shape) pair, skips applied."""
    return [(a, s) for a in ARCH_IDS for s in REGISTRY[a].shapes]
