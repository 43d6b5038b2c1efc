"""Registry: ``--arch <id>`` → ArchConfig (full or smoke-reduced)."""
from __future__ import annotations

from typing import Dict, List

from .base import ArchConfig, SHAPES, ShapeConfig, cell_is_applicable
from . import (
    qwen2_7b,
    h2o_danube_3_4b,
    minicpm3_4b,
    tinyllama_1_1b,
    whisper_large_v3,
    mamba2_130m,
    zamba2_1_2b,
    internvl2_76b,
    deepseek_moe_16b,
    llama4_scout_17b_a16e,
)

__all__ = ["ARCHS", "get_config", "get_smoke_config", "list_archs", "all_cells"]

_MODULES = [
    qwen2_7b,
    h2o_danube_3_4b,
    minicpm3_4b,
    tinyllama_1_1b,
    whisper_large_v3,
    mamba2_130m,
    zamba2_1_2b,
    internvl2_76b,
    deepseek_moe_16b,
    llama4_scout_17b_a16e,
]

ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES: Dict[str, ArchConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}

# served configurations beyond the ten assigned architectures, found by name
# but outside ARCHS and the assigned cells (the JAX package has no twin)
_EXTRA: Dict[str, ArchConfig] = {zamba2_1_2b.PUBLISHED.name: zamba2_1_2b.PUBLISHED}
_EXTRA_SMOKES: Dict[str, ArchConfig] = {zamba2_1_2b.PUBLISHED.name: zamba2_1_2b.PUBLISHED_SMOKE}


def get_config(name: str) -> ArchConfig:
    found = ARCHS.get(name) or _EXTRA.get(name)
    if found is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(_EXTRA)}")
    return found


def get_smoke_config(name: str) -> ArchConfig:
    found = SMOKES.get(name) or _EXTRA_SMOKES.get(name)
    if found is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(SMOKES) + sorted(_EXTRA_SMOKES)}")
    return found


def list_archs() -> List[str]:
    return list(ARCHS)


def all_cells(include_skipped: bool = False):
    """Yield (arch, shape, applicable, reason) for the 40 assigned cells."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, reason = cell_is_applicable(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok, reason
