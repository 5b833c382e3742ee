"""Architecture registry: arch id -> config, smoke config and family.

Each entry carries the exact assigned config and a reduced smoke config;
the model code that runs them is :mod:`repro_torch.models` and the
serving launcher :mod:`repro_torch.launch.serve`.  The JAX package's
entries also carry dry-run shape cells and input specs, which belong to
its training and dry-run launchers and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import (gemma2_2b, granite_3_2b, kimi_k2_1t_a32b,
                                 mamba2_1_3b, minicpm_2b, olmoe_1b_7b,
                                 phi3_medium_14b, pixtral_12b,
                                 recurrentgemma_2b, whisper_base)
from repro_torch.models.encdec import EncDecCfg


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    config: object                    # ModelCfg | EncDecCfg
    smoke: Callable[[], object]
    family: str

    @property
    def is_encdec(self) -> bool:
        return isinstance(self.config, EncDecCfg)


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
            arch_id=mod.ARCH_ID, config=mod.CONFIG, smoke=mod.smoke,
            family=family)

ARCH_IDS = sorted(REGISTRY)


def get(arch_id: str) -> ArchEntry:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return REGISTRY[arch_id]
