from .base import ArchConfig, ShapeConfig, SHAPES, cell_is_applicable
from .registry import ARCHS, SMOKES, get_config, get_smoke_config, list_archs, all_cells

__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "cell_is_applicable",
    "ARCHS",
    "SMOKES",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "all_cells",
]
