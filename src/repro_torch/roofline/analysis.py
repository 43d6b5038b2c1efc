"""Three-term roofline from dry-run artifacts.

Port of ``repro/roofline/analysis.py``, with the arithmetic kept verbatim.
For every (arch × shape × mesh) cell::

    compute    = dot_FLOPs_per_device / PEAK_FLOPS               [s]
    memory     = hbm_bytes_per_device / HBM_BW                   [s]
    collective = collective_bytes_per_device / LINK_BW           [s]

The constants are :class:`HW`'s.  Its defaults are NVIDIA's data-sheet
figures for the ``NVIDIA H100 80GB HBM3`` (SXM, dense, at its full 700 W
limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them,
3.35 TB/s of HBM3.  They are not measurements.  The collective term
divides by one link, as the reference's does; on a 16×16 (or 2×16×16)
H100 mesh both axes cross nodes of 8 cards, so the link is one NDR
InfiniBand port, 400 Gb/s = 50 GB/s (data sheet) — the conservative
choice; NVLink inside a node is faster.

Methodology notes (consistent across cells):

* FLOPs/bytes come from the dry-run's per-device op count
  (:mod:`repro_torch.roofline.op_count`); eager runs every layer, so
  nothing is counted once for many loop trips.
* the memory term reads ``hbm_bytes`` (every op's output written and read
  once; eager PyTorch fuses nothing, so it is larger than XLA's count),
  with ``dot_bytes`` as the fallback floor.
* collective bytes are per-device (each collective's result on one rank)
  over one link — a single-link model.
* MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens (inference)
  — the "useful work" yardstick; ``flops_ratio`` = MODEL/counted catches
  remat and padding waste; ``roofline_fraction`` = ideal-compute-time /
  dominant-term-time is the headline score.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from ..configs import SHAPES, get_config

__all__ = ["HW", "RooflineCell", "analyze_cell", "load_cells", "format_table", "model_flops", "decode_min_bytes"]


@dataclass(frozen=True)
class HW:
    """One device's peaks; data-sheet figures of the NVIDIA H100 80GB HBM3
    (SXM, dense, 700 W), never measurements."""

    peak_flops: float = 989e12  # bf16 per card, tensor cores
    hbm_bw: float = 3.35e12  # bytes/s per card, HBM3
    ici_link_bw: float = 50e9  # bytes/s per link: one NDR InfiniBand port (400 Gb/s)
    peak_flops_f32: float = 67e12  # f32 per card, outside the tensor cores


DEFAULT_HW = HW()


@dataclass
class RooflineCell:
    cell: str
    arch: str
    shape: str
    mesh: str
    kind: str
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    hlo_flops_global: float
    flops_ratio: float  # MODEL / counted (useful fraction of the compute)
    roofline_fraction: float  # ideal compute time / dominant term
    note: str = ""

    @property
    def dominant_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def model_flops(arch_name: str, shape_name: str) -> float:
    arch = get_config(arch_name)
    shape = SHAPES[shape_name]
    n = arch.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per request


def decode_min_bytes(arch_name: str, shape_name: str) -> float:
    """Bandwidth floor for one decode step: every active parameter and the
    live KV/state cache must stream from HBM at least once (global bytes)."""
    arch = get_config(arch_name)
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    param_bytes = 2.0 * arch.active_param_count()
    cache = 0.0
    L = arch.n_layers
    if arch.has_ssm:
        d_in = arch.ssm_expand * arch.d_model
        heads = d_in // arch.ssm_head_dim
        cache += L * b * heads * arch.ssm_head_dim * arch.ssm_state * 2  # SSM state
        n_attn = (L + arch.attn_every - 1) // arch.attn_every if arch.attn_every else 0
    else:
        n_attn = L
    if arch.attn_kind == "mla":
        cache += n_attn * b * s * (arch.kv_lora_rank + arch.rope_head_dim) * 2
    elif n_attn:
        slots = s
        if arch.attn_kind in ("swa", "chunked") and arch.window and not arch.global_every:
            slots = min(s, arch.window)
        if arch.global_every:  # mixed: local layers bounded, global layers full
            n_local = n_attn - n_attn // arch.global_every
            n_glob = n_attn // arch.global_every
            cache += (n_local * min(s, arch.window) + n_glob * s) * b * arch.n_kv_heads * arch.resolved_head_dim * 2 * 2
        else:
            cache += n_attn * b * slots * arch.n_kv_heads * arch.resolved_head_dim * 2 * 2
    return param_bytes + cache


def analyze_cell(rec: Dict, hw: HW = DEFAULT_HW) -> Optional[RooflineCell]:
    if rec.get("status") != "ok":
        return None
    nd = rec["n_devices"]
    dot_flops = rec.get("dot_flops", 0.0)  # per device
    # memory term: materialized-op bytes when available; dot operand/output
    # bytes as the fallback floor
    mem_bytes = rec.get("hbm_bytes") or rec.get("dot_bytes", 0.0)
    coll = sum(rec.get("collective_bytes", {}).values())
    compute_s = dot_flops / hw.peak_flops
    memory_s = mem_bytes / hw.hbm_bw
    collective_s = coll / hw.ici_link_bw
    mf = model_flops(rec["arch"], rec["shape"])
    hlo_global = dot_flops * nd
    dom = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda t: t[1],
    )[0]
    # ideal time: compute floor, plus the bandwidth floor for decode
    ideal = mf / nd / hw.peak_flops
    if rec["kind"] == "decode":
        ideal = max(ideal, decode_min_bytes(rec["arch"], rec["shape"]) / nd / hw.hbm_bw)
    dominant = max(compute_s, memory_s, collective_s)
    return RooflineCell(
        cell=rec["cell"],
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        kind=rec["kind"],
        n_devices=nd,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dom,
        model_flops_global=mf,
        hlo_flops_global=hlo_global,
        flops_ratio=mf / hlo_global if hlo_global else 0.0,
        roofline_fraction=ideal / dominant if dominant else 0.0,
    )


def load_cells(dry_dir: str, mesh_filter: Optional[str] = None, hw: HW = DEFAULT_HW) -> List[RooflineCell]:
    out = []
    for p in sorted(Path(dry_dir).glob("*.json")):
        rec = json.loads(p.read_text())
        if mesh_filter and rec.get("mesh") != mesh_filter:
            continue
        c = analyze_cell(rec, hw)
        if c is not None:
            out.append(c)
    return out


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:7.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:6.1f}ms"
    return f"{x*1e6:6.0f}µs"


def format_table(cells: List[RooflineCell]) -> str:
    hdr = (
        "| cell | mesh | compute | memory | collective | dominant | MODEL/HLO | roofline frac |\n"
        "|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for c in cells:
        rows.append(
            f"| {c.arch}×{c.shape} | {c.mesh} | {_fmt_s(c.compute_s)} | {_fmt_s(c.memory_s)} "
            f"| {_fmt_s(c.collective_s)} | **{c.dominant}** | {c.flops_ratio:.2f} | {c.roofline_fraction:.2%} |"
        )
    return hdr + "\n".join(rows) + "\n"
