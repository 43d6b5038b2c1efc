"""Pass registry, analysis context, findings, and the reviewed baseline.

A pass is ``fn(ctx) -> list[Finding]`` registered under a stable id.
Findings carry a **line-number-free fingerprint** (pass id + file +
rule-specific key) so the reviewed baseline in
``tools/torch_analysis_baseline.json`` survives unrelated edits: moving a
function does not invalidate its baseline entry; changing the violation
itself does.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from .callgraph import CallGraph
from .facts import GLOBAL_CACHE, ModuleFacts

__all__ = [
    "Finding",
    "PassSpec",
    "analysis_pass",
    "all_passes",
    "run_passes",
    "AnalysisContext",
    "load_baseline",
    "split_findings",
]


@dataclass
class Finding:
    pass_id: str
    file: str  # repo-relative posix path ("" for runtime gates)
    line: int
    message: str
    key: str  # stable rule-specific detail (NO line numbers)
    witness: Tuple[str, ...] = ()

    @property
    def fingerprint(self) -> str:
        return f"{self.pass_id}:{self.file}:{self.key}"

    def to_json(self) -> Dict[str, object]:
        return {
            "pass": self.pass_id,
            "file": self.file,
            "line": self.line,
            "message": self.message,
            "fingerprint": self.fingerprint,
            "witness": list(self.witness),
        }


@dataclass
class PassSpec:
    pass_id: str
    title: str
    fn: Callable[["AnalysisContext"], List[Finding]]


_REGISTRY: Dict[str, PassSpec] = {}


def analysis_pass(pass_id: str, title: str):
    """Register an analysis pass (decorator)."""

    def deco(fn: Callable[["AnalysisContext"], List[Finding]]):
        _REGISTRY[pass_id] = PassSpec(pass_id, title, fn)
        return fn

    return deco


def all_passes() -> Dict[str, PassSpec]:
    # importing the pass modules populates the registry
    from . import passes as _passes  # noqa: F401
    from . import gates as _gates  # noqa: F401

    return dict(_REGISTRY)


def run_passes(
    ctx: "AnalysisContext", pass_ids: Optional[Iterable[str]] = None
) -> List[Finding]:
    specs = all_passes()
    if pass_ids is None:
        selected = list(specs.values())
    else:
        unknown = [p for p in pass_ids if p not in specs]
        if unknown:
            raise KeyError(f"unknown pass(es): {', '.join(unknown)}")
        selected = [specs[p] for p in pass_ids]
    findings: List[Finding] = []
    for spec in selected:
        findings.extend(spec.fn(ctx))
    return findings


# ------------------------------------------------------------------ context
class AnalysisContext:
    """Everything a pass needs: the per-module facts (one cached walk
    each), the call graph, and lazily-attached shared models (the lock
    model hangs itself here so lock-order and blocking-under-lock share
    one inter-procedural walk)."""

    def __init__(self, root: Path, modules: Dict[str, ModuleFacts]):
        self.root = root
        self.modules = modules
        self.graph = CallGraph(modules)
        self._extras: Dict[str, object] = {}

    # shared-model slot (used by passes.get_lock_model)
    def extra(self, key: str, build: Callable[[], object]) -> object:
        if key not in self._extras:
            self._extras[key] = build()
        return self._extras[key]

    # ------------------------------------------------------------ builders
    @classmethod
    def for_repo(cls, root: Path) -> "AnalysisContext":
        """All of ``src/repro_torch`` except the analysis package itself
        (the system under analysis, not the analyzer)."""
        src = root / "src"
        modules: Dict[str, ModuleFacts] = {}
        for path in sorted((src / "repro_torch").rglob("*.py")):
            rel = path.relative_to(root).as_posix()
            if rel.startswith("src/repro_torch/analysis/"):
                continue
            name = ".".join(path.relative_to(src).with_suffix("").parts)
            if name.endswith(".__init__"):
                name = name[: -len(".__init__")]
            modules[name] = GLOBAL_CACHE.get(path, name, rel)
        return cls(root, modules)

    @classmethod
    def from_sources(cls, sources: Dict[str, str], root: Optional[Path] = None) -> "AnalysisContext":
        """Fixture contexts for tests: ``{relpath: source}``."""
        modules: Dict[str, ModuleFacts] = {}
        for rel, src in sources.items():
            name = rel[:-3].replace("/", ".") if rel.endswith(".py") else rel.replace("/", ".")
            modules[name] = ModuleFacts.from_source(src, name, rel)
        return cls(root or Path("."), modules)

    # ------------------------------------------------------------- queries
    def module_at(self, path_suffix: str) -> Optional[ModuleFacts]:
        for mod in self.modules.values():
            if mod.path and mod.path.endswith(path_suffix):
                return mod
        return None

    def iter_functions(
        self, path_prefixes: Optional[Tuple[str, ...]] = None
    ) -> Iterator[Tuple[ModuleFacts, "object"]]:
        """(module, FunctionFacts) pairs, optionally restricted to repo
        sub-trees.  Fixture modules (paths outside ``src/repro_torch``) are
        always included so tests can run passes on synthetic trees."""
        for mod in self.modules.values():
            if path_prefixes is not None and mod.path and mod.path.startswith("src/repro_torch/"):
                if not any(mod.path.startswith(p) for p in path_prefixes):
                    continue
            for ff in mod.functions.values():
                yield mod, ff


# ----------------------------------------------------------------- baseline
def load_baseline(path: Optional[Path]) -> Dict[str, str]:
    """``{fingerprint: reason}`` from the reviewed allowlist file."""
    if path is None or not path.exists():
        return {}
    data = json.loads(path.read_text())
    out: Dict[str, str] = {}
    for entry in data.get("entries", []):
        out[entry["fingerprint"]] = entry.get("reason", "")
    return out


def split_findings(
    findings: List[Finding], baseline: Dict[str, str]
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """(new, baselined, stale-baseline-fingerprints)."""
    new: List[Finding] = []
    accepted: List[Finding] = []
    seen = set()
    for f in findings:
        seen.add(f.fingerprint)
        (accepted if f.fingerprint in baseline else new).append(f)
    stale = [fp for fp in baseline if fp not in seen]
    return new, accepted, stale
