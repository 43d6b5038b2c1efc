"""Shared pieces of the benchmark's CPU tests: smoke-sized configurations
made from the committed configuration files."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.cells import CONFIG_META, read_json  # noqa: E402

HERE = ROOT / "perfbench"


def smoke_cfg(name: str, dtype: str = "float32") -> dict:
    """The configuration file ``name`` at the port's smoke sizes."""
    from repro_torch.configs import get_smoke_config

    cfg = read_json(HERE / "configs" / f"{name}.json")
    smoke = dataclasses.asdict(get_smoke_config(cfg["port_arch"]))
    for k in list(cfg):
        if k not in CONFIG_META and k in smoke:
            cfg[k] = smoke[k]
    cfg["dtype"] = dtype
    return cfg
