"""The roofline of the dry-run's cells (:mod:`.analysis`) and the
per-device op count that feeds it (:mod:`.op_count`, the port's
counterpart of the reference's ``hlo_parse``)."""
from .analysis import HW, RooflineCell, analyze_cell, decode_min_bytes, format_table, load_cells, model_flops
from .op_count import OpCount, count_ops

__all__ = [
    "HW",
    "RooflineCell",
    "analyze_cell",
    "decode_min_bytes",
    "format_table",
    "load_cells",
    "model_flops",
    "OpCount",
    "count_ops",
]
