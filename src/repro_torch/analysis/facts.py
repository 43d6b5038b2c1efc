"""Shared AST facts: ONE cached tree walk per module.

Every pass consumes the same :class:`ModuleFacts` — import-alias map,
class table (base names, ``self.attr`` type hints, lock-bearing
attributes), function table (parameter/return annotations, simple local
assignments) — so adding a pass never adds another parse.  Facts are
deliberately *syntactic and resolvable*, not a type system: the
call-graph layer (:mod:`.callgraph`) only follows edges it can resolve
with confidence, and every pass documents what the under-approximation
misses.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "ModuleFacts",
    "ClassFacts",
    "FunctionFacts",
    "FactsCache",
    "LOCK_CONSTRUCTORS",
    "ann_name",
]

#: constructor names whose result is a mutex the passes track.  Both the
#: raw primitives and the sanitizer's :func:`~repro_torch.analysis.sanitizer.
#: make_lock` wrapper count, so instrumenting a module never blinds the
#: static side.
LOCK_CONSTRUCTORS = {"Lock", "RLock", "make_lock"}


def ann_name(node: Optional[ast.AST]) -> Optional[str]:
    """The class name an annotation denotes (best-effort, string
    annotations included): ``Fabric``, ``"Fabric"``, ``Optional[Fabric]``,
    ``mod.Fabric`` all resolve to ``"Fabric"``."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        text = node.value.strip().strip("'\"")
        try:
            return ann_name(ast.parse(text, mode="eval").body)
        except SyntaxError:
            return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        base = ann_name(node.value)
        if base in ("Optional", "optional"):
            return ann_name(node.slice)
        return None
    return None


def _callee_name(func: ast.AST) -> Optional[str]:
    """Terminal name of a call target: ``Lock`` for both ``Lock(...)``
    and ``threading.Lock(...)``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


@dataclass
class FunctionFacts:
    """One function or method: the raw node plus resolution hints."""

    name: str  # bare name
    qualname: str  # "fn" or "Class.fn"
    module: str  # dotted module name
    node: ast.AST = field(repr=False)
    class_name: Optional[str] = None
    param_types: Dict[str, str] = field(default_factory=dict)
    return_type: Optional[str] = None
    #: simple ``name = <expr>`` local assignments (last one wins) — the
    #: callgraph chases these for receiver-type inference
    local_assigns: Dict[str, ast.expr] = field(default_factory=dict, repr=False)

    @property
    def qualid(self) -> str:
        return f"{self.module}:{self.qualname}"


@dataclass
class ClassFacts:
    name: str
    module: str
    base_names: List[str] = field(default_factory=list)
    methods: Dict[str, FunctionFacts] = field(default_factory=dict)
    #: ``self.attr`` → class-name hint (constructor call, annotated
    #: parameter assignment, or annotated attribute)
    attr_types: Dict[str, str] = field(default_factory=dict)
    #: attributes assigned a lock constructor (``threading.Lock()``,
    #: ``make_lock(...)``) anywhere in the class
    lock_attrs: Set[str] = field(default_factory=set)


@dataclass
class ModuleFacts:
    name: str  # dotted, e.g. "repro_torch.core.fabric"
    path: Optional[str]  # repo-relative posix path, None for fixtures
    tree: ast.Module = field(repr=False)
    #: local name → fully dotted import target
    import_aliases: Dict[str, str] = field(default_factory=dict)
    classes: Dict[str, ClassFacts] = field(default_factory=dict)
    functions: Dict[str, FunctionFacts] = field(default_factory=dict)
    #: module-level names assigned a lock constructor
    module_locks: Set[str] = field(default_factory=set)

    # ------------------------------------------------------------- builders
    @classmethod
    def from_source(cls, source: str, name: str, path: Optional[str] = None) -> "ModuleFacts":
        tree = ast.parse(source)
        facts = cls(name=name, path=path, tree=tree)
        facts._collect()
        return facts

    @classmethod
    def from_path(cls, file_path: Path, name: str, rel: str) -> "ModuleFacts":
        return cls.from_source(file_path.read_text(), name, rel)

    # ------------------------------------------------------------ collection
    def _collect(self) -> None:
        self._collect_imports()
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self._collect_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ff = self._function_facts(node, class_name=None)
                self.functions[ff.qualname] = ff
            elif isinstance(node, ast.Assign) and self._is_lock_ctor(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.module_locks.add(tgt.id)

    def _collect_imports(self) -> None:
        pkg_parts = self.name.split(".")[:-1]
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.import_aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    mod = ".".join(base + ([node.module] if node.module else []))
                else:
                    mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.import_aliases[a.asname or a.name] = f"{mod}.{a.name}"

    def _is_lock_ctor(self, value: ast.AST) -> bool:
        if not isinstance(value, ast.Call):
            return False
        return _callee_name(value.func) in LOCK_CONSTRUCTORS

    def _collect_class(self, node: ast.ClassDef) -> None:
        cf = ClassFacts(name=node.name, module=self.name)
        for b in node.bases:
            bname = _callee_name(b) if not isinstance(b, ast.Name) else b.id
            if bname:
                cf.base_names.append(bname)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ff = self._function_facts(item, class_name=node.name)
                cf.methods[item.name] = ff
                self.functions[ff.qualname] = ff
                self._collect_self_attrs(item, ff, cf)
            elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                t = ann_name(item.annotation)
                if t:
                    cf.attr_types[item.target.id] = t
        self.classes[node.name] = cf

    def _collect_self_attrs(self, method: ast.AST, ff: FunctionFacts, cf: ClassFacts) -> None:
        for node in ast.walk(method):
            target: Optional[ast.Attribute] = None
            value: Optional[ast.expr] = None
            annotation: Optional[ast.AST] = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                if isinstance(node.targets[0], ast.Attribute):
                    target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Attribute):
                target, value, annotation = node.target, node.value, node.annotation
            if target is None or not (
                isinstance(target.value, ast.Name) and target.value.id == "self"
            ):
                continue
            attr = target.attr
            if value is not None and self._is_lock_ctor(value):
                cf.lock_attrs.add(attr)
                continue
            hint = ann_name(annotation) if annotation is not None else None
            if hint is None and isinstance(value, ast.Call):
                hint = _callee_name(value.func)
            if hint is None and isinstance(value, ast.Name):
                hint = ff.param_types.get(value.id)
            if hint and attr not in cf.attr_types:
                cf.attr_types[attr] = hint

    def _function_facts(self, node: ast.AST, class_name: Optional[str]) -> FunctionFacts:
        qual = f"{class_name}.{node.name}" if class_name else node.name
        ff = FunctionFacts(
            name=node.name,
            qualname=qual,
            module=self.name,
            node=node,
            class_name=class_name,
        )
        args = node.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            t = ann_name(a.annotation)
            if t:
                ff.param_types[a.arg] = t
        ff.return_type = ann_name(node.returns)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                tgt = sub.targets[0]
                if isinstance(tgt, ast.Name):
                    ff.local_assigns[tgt.id] = sub.value
            elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                t = ann_name(sub.annotation)
                if t:
                    ff.param_types.setdefault(sub.target.id, t)
        return ff


class FactsCache:
    """Path-keyed cache: one parse + fact walk per (path, mtime)."""

    def __init__(self) -> None:
        self._cache: Dict[str, Tuple[float, ModuleFacts]] = {}

    def get(self, file_path: Path, name: str, rel: str) -> ModuleFacts:
        key = str(file_path)
        mtime = file_path.stat().st_mtime
        hit = self._cache.get(key)
        if hit is not None and hit[0] == mtime:
            return hit[1]
        facts = ModuleFacts.from_path(file_path, name, rel)
        self._cache[key] = (mtime, facts)
        return facts


#: process-wide cache shared by the CLI and tests
GLOBAL_CACHE = FactsCache()
