"""Find a cell, its configuration and its traffic mix by name.

Every lookup goes by a name to a file of its own under ``perfbench/``, so
a new cell, configuration, mix, metric or model family is a new file,
never an edit.  A family is its reference module,
``reference/<cfg["reference"]>.py``: besides the forward pass
(``served_logits``) it gives the parameter tree (``layout``) and the
products a token (``per_token_flops``, ``attention_calls``, and optionally
``attention_score_flops``), which :func:`family` finds.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the keys of a configuration file that are not sizes of the port's ArchConfig
CONFIG_META = ("name", "source", "port_arch", "reference", "reduced", "assumed", "departures", "published")


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, base: Path = HERE) -> Dict[str, Any]:
    """The cell ``name`` with its configuration (``cell["cfg"]``) and its
    traffic mix (``cell["mix"]``) resolved from their files."""
    path = base / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no cell {name!r}: {path} does not exist")
    cell = read_json(path)
    if cell["name"] != name:
        raise ValueError(f"{path} names the cell {cell['name']!r}")
    cell["cfg"] = read_json(base / "configs" / f"{cell['config']}.json")
    cell["mix"] = read_json(base / "traffic" / f"{cell['traffic']}.json")
    return cell


def benchmark_entries(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Dict[str, list]:
    """The end-to-end and per-layer metrics of ``BENCHMARK.json`` that the
    cell ``name`` reports: those whose ``workloads`` list it, and those
    without the key."""
    bench = read_json(bench_path)
    pick = lambda ms: [m for m in ms if name in m.get("workloads", [name])]  # noqa: E731
    return {"end_to_end": pick(bench["end_to_end"]), "per_layer": pick(bench["per_layer"])}


def load_module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module; the file name may hold
    dots (``mfu.decode``), so it is loaded by path."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cfg: Dict[str, Any], fn: str, required: bool = True):
    """The function ``fn`` of the reference module that ``cfg["reference"]``
    names; None where an optional one is missing."""
    mod = load_module("reference", cfg["reference"])
    f = getattr(mod, fn, None)
    if f is None and required:
        raise AttributeError(f"{mod.__file__} has no {fn}(): a family's reference module gives layout, "
                             "per_token_flops, attention_calls and served_logits")
    return f


def arch_config(cfg: Dict[str, Any]):
    """The port's ArchConfig for a configuration file: the port's named
    configuration with every size the file gives."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    sizes = {k: v for k, v in cfg.items() if k in fields and k not in CONFIG_META}
    unknown = set(cfg) - fields - set(CONFIG_META)
    if unknown:
        raise ValueError(f"configuration {cfg['name']!r} has keys the port does not know: {sorted(unknown)}")
    return get_config(cfg["port_arch"]).variant(**sizes)
