"""Confident-edge call graph + lock identity over the shared facts.

Resolution follows only edges it can justify (documented
under-approximation — an unresolved call contributes nothing, it never
guesses):

* bare names → same-module functions, alias-resolved imports of analyzed
  modules, class constructors;
* ``self.m()`` → the enclosing class and its resolvable bases;
* ``obj.m()`` → receiver type inferred from parameter/attribute
  annotations, ``self.x = ClassName(...)`` constructor assignments,
  simple local assignments, and annotated return types (all collected in
  one facts walk);
* ``module.fn()`` → alias-resolved module attribute.

Lock identity is class-granular: ``(OwnerClass, attr)`` — ``self._lock``
inside ``Membership`` is ``Membership._lock``.  Two *instances* of the
same class share an identity, which deliberately over-approximates:
nested acquisition across instances of one class is flagged, exactly the
hand-over-hand pattern a non-total order makes deadlock-prone.  An
attribute whose receiver type cannot be inferred resolves only when a
single analyzed class defines that attribute as a lock.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .facts import FunctionFacts, ClassFacts, ModuleFacts, ann_name

__all__ = ["CallGraph", "callee_name"]


def callee_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class CallGraph:
    def __init__(self, modules: Dict[str, ModuleFacts]):
        self.modules = modules
        self.class_index: Dict[str, List[ClassFacts]] = {}
        self.lock_attr_owners: Dict[str, List[ClassFacts]] = {}
        for mod in modules.values():
            for cf in mod.classes.values():
                self.class_index.setdefault(cf.name, []).append(cf)
                for attr in cf.lock_attrs:
                    self.lock_attr_owners.setdefault(attr, []).append(cf)

    # ------------------------------------------------------ class resolution
    def resolve_class(self, name: Optional[str], mod: Optional[ModuleFacts]) -> Optional[ClassFacts]:
        if not name:
            return None
        if mod is not None:
            cf = mod.classes.get(name)
            if cf is not None:
                return cf
            target = mod.import_aliases.get(name)
            if target:
                owner, _, obj = target.rpartition(".")
                owner_mod = self.modules.get(owner)
                if owner_mod is not None:
                    return owner_mod.classes.get(obj)
                name = obj  # fall through to the unique-global lookup
        candidates = self.class_index.get(name, [])
        if len(candidates) == 1:
            return candidates[0]
        return None

    def mro(self, cf: ClassFacts) -> List[ClassFacts]:
        """Linearized base chain (BFS over resolvable bases)."""
        out, seen, frontier = [], set(), [cf]
        while frontier:
            c = frontier.pop(0)
            key = (c.module, c.name)
            if key in seen:
                continue
            seen.add(key)
            out.append(c)
            cmod = self.modules.get(c.module)
            for b in c.base_names:
                bcf = self.resolve_class(b, cmod)
                if bcf is not None:
                    frontier.append(bcf)
        return out

    # -------------------------------------------------------- type inference
    def infer_type(
        self, expr: ast.AST, ff: FunctionFacts, mod: ModuleFacts, depth: int = 0
    ) -> Optional[Tuple[str, ClassFacts]]:
        """Best-effort receiver type: ``("instance", cls)`` for a value of
        that class, ``("class", cls)`` for a reference to the class object
        itself, None when unsure."""
        if depth > 5:
            return None
        if isinstance(expr, ast.Name):
            if expr.id == "self" and ff.class_name:
                cf = self.resolve_class(ff.class_name, mod)
                return ("instance", cf) if cf else None
            t = ff.param_types.get(expr.id)
            if t:
                cf = self.resolve_class(t, mod)
                if cf:
                    return ("instance", cf)
            rhs = ff.local_assigns.get(expr.id)
            if rhs is not None and not (isinstance(rhs, ast.Name) and rhs.id == expr.id):
                inferred = self.infer_type(rhs, ff, mod, depth + 1)
                if inferred:
                    return inferred
            cf = self.resolve_class(expr.id, mod)
            if cf:
                return ("class", cf)
            return None
        if isinstance(expr, ast.Attribute):
            base = self.infer_type(expr.value, ff, mod, depth + 1)
            if base and base[0] == "instance":
                for c in self.mro(base[1]):
                    hint = c.attr_types.get(expr.attr)
                    if hint:
                        cf = self.resolve_class(hint, self.modules.get(c.module))
                        if cf:
                            return ("instance", cf)
                        return None
            return None
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name):
                cf = self.resolve_class(expr.func.id, mod)
                if cf:
                    return ("instance", cf)
            for fn in self.resolve_call(expr, ff, mod, depth + 1):
                if fn.return_type:
                    cf = self.resolve_class(fn.return_type, self.modules.get(fn.module))
                    if cf:
                        return ("instance", cf)
            return None
        if isinstance(expr, ast.Await):
            return self.infer_type(expr.value, ff, mod, depth + 1)
        return None

    # -------------------------------------------------------- call resolution
    def resolve_call(
        self, call: ast.Call, ff: FunctionFacts, mod: ModuleFacts, depth: int = 0
    ) -> List[FunctionFacts]:
        if depth > 6:
            return []
        func = call.func
        if isinstance(func, ast.Name):
            n = func.id
            local = mod.functions.get(n)
            if local is not None and local.class_name is None:
                return [local]
            cf = mod.classes.get(n)
            if cf is not None:
                init = cf.methods.get("__init__")
                return [init] if init else []
            target = mod.import_aliases.get(n)
            if target:
                owner, _, obj = target.rpartition(".")
                owner_mod = self.modules.get(owner)
                if owner_mod is not None:
                    f = owner_mod.functions.get(obj)
                    if f is not None:
                        return [f]
                    cf = owner_mod.classes.get(obj)
                    if cf is not None:
                        init = cf.methods.get("__init__")
                        return [init] if init else []
            return []
        if isinstance(func, ast.Attribute):
            m = func.attr
            base = self.infer_type(func.value, ff, mod, depth + 1)
            if base is not None and base[1] is not None:
                for c in self.mro(base[1]):
                    if m in c.methods:
                        return [c.methods[m]]
                return []
            if isinstance(func.value, ast.Name):
                target = mod.import_aliases.get(func.value.id)
                if target:
                    owner_mod = self.modules.get(target)
                    if owner_mod is not None:
                        f = owner_mod.functions.get(m)
                        if f is not None and f.class_name is None:
                            return [f]
            return []
        return []

    # ---------------------------------------------------------- lock identity
    def lock_id(self, expr: ast.AST, ff: FunctionFacts, mod: ModuleFacts) -> Optional[str]:
        """Canonical lock identity for a context-manager / ``.acquire()``
        base expression, or None if it is not a recognized lock."""
        if isinstance(expr, ast.Name):
            if expr.id in mod.module_locks:
                return f"{mod.name.rsplit('.', 1)[-1]}.{expr.id}"
            rhs = ff.local_assigns.get(expr.id)
            if isinstance(rhs, ast.Attribute):
                return self.lock_id(rhs, ff, mod)
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        base = self.infer_type(expr.value, ff, mod)
        if base is not None and base[1] is not None:
            for c in self.mro(base[1]):
                if attr in c.lock_attrs:
                    return f"{c.name}.{attr}"
            return None
        owners = {c.name for c in self.lock_attr_owners.get(attr, [])}
        if len(owners) == 1:
            return f"{owners.pop()}.{attr}"
        return None

    # --------------------------------------------------------- name targeting
    def resolves_to(self, call: ast.Call, mod: ModuleFacts, full_name: str) -> bool:
        """Whether ``call`` targets the fully-dotted ``full_name`` (e.g.
        ``threading.Thread``), via direct use or any import alias."""
        owner, _, obj = full_name.rpartition(".")
        func = call.func
        if isinstance(func, ast.Name):
            return mod.import_aliases.get(func.id) == full_name
        if isinstance(func, ast.Attribute) and func.attr == obj:
            if isinstance(func.value, ast.Name):
                return mod.import_aliases.get(func.value.id) == owner
        return False
