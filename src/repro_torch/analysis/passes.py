"""The five concurrency passes.

All five ride the same facts + call graph; lock-order and
blocking-under-lock additionally share ONE inter-procedural lock model
(:class:`LockModel`): a linear held-set walk per function (with-blocks,
``.acquire()``/``.release()``, leak/release summaries for split
acquire/release helpers like ``LCIDevice._acquire``), plus memoized
transitive summaries (which locks a callee may acquire, which blocking
calls it may reach) with witness chains.

Documented under-approximations: unresolved calls (lambdas handed to
throttles, duck-typed ``Any`` receivers) contribute no edges; nested
``def``/``lambda`` bodies are deferred execution and are not walked as
part of the enclosing function; branches merge held-sets by union
(may-hold analysis).
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Set, Tuple

from .callgraph import CallGraph, callee_name
from .facts import FunctionFacts, ModuleFacts
from .registry import AnalysisContext, Finding, analysis_pass

__all__ = [
    "LockModel",
    "get_lock_model",
    "BLOCKING_CALLS",
    "POST_STATUS_VERBS",
    "LOCK_SCOPE",
]

#: the sub-trees the lock passes police (paper §5.3: the communication
#: layer's progress/completion discipline)
LOCK_SCOPE = (
    "src/repro_torch/core/",
    "src/repro_torch/serve/",
    "src/repro_torch/amtsim/",
)

#: call names that can block or take unbounded library time while the
#: caller sits on a lock (§5.3: "blocking under a lock is catastrophic").
#: ``join``/``wait`` with an explicit timeout argument are exempt.
BLOCKING_CALLS = {
    "sleep",
    "join",
    "wait",
    "device_put",
    "post_send",
    "post_put_signal",
    "post_put",
    "progress",
    "poll",
    "poll_cq",
    "hw_progress",
    "reap",
    "run_step",
}
_TIMEOUT_EXEMPT = {"join", "wait"}

#: CommInterface verbs returning a PostStatus the caller must observe
#: (``post_recv`` returns None and ``progress``/``poll`` return a moved
#: flag, so only the posting verbs carry a refusable EAGAIN)
POST_STATUS_VERBS = {"post_send", "post_put_signal", "post_put"}


def _loc(mod: ModuleFacts, line: int) -> str:
    return f"{mod.path or mod.name}:{line}"


def _timeout_exempt(call: ast.Call, name: str) -> bool:
    if name not in _TIMEOUT_EXEMPT:
        return False
    if call.args:
        return True
    return any(kw.arg == "timeout" for kw in call.keywords)


# ======================================================== lock model walker
class _Direct:
    """Per-function direct summary from one held-set walk."""

    __slots__ = ("acquires", "leaked", "released_extra", "blocking", "calls")

    def __init__(self) -> None:
        self.acquires: Dict[str, int] = {}  # lock id -> first line
        self.leaked: Dict[str, int] = {}  # held at end of linear walk
        self.released_extra: Set[str] = set()  # released without acquiring
        self.blocking: List[Tuple[str, int]] = []  # (name, line)
        self.calls: List[Tuple[int, FunctionFacts]] = []  # resolved only


class LockModel:
    def __init__(self, ctx: AnalysisContext):
        self.ctx = ctx
        self.graph: CallGraph = ctx.graph
        self._direct: Dict[str, _Direct] = {}
        self._building: Set[str] = set()
        self._trans_acq: Dict[str, Dict[str, List[str]]] = {}
        self._trans_blk: Dict[str, List[Tuple[str, List[str]]]] = {}
        self._mod_of: Dict[str, ModuleFacts] = {}
        for mod in ctx.modules.values():
            for ff in mod.functions.values():
                self._mod_of[ff.qualid] = mod

    def module_of(self, ff: FunctionFacts) -> ModuleFacts:
        return self._mod_of[ff.qualid]

    # ----------------------------------------------------------- the walker
    def walk(
        self,
        ff: FunctionFacts,
        on_acquire: Optional[Callable[[str, int, Tuple[Tuple[str, int], ...]], None]] = None,
        on_call: Optional[
            Callable[[ast.Call, List[FunctionFacts], Tuple[Tuple[str, int], ...]], None]
        ] = None,
    ) -> _Direct:
        """One linear held-set walk of ``ff``.  Callbacks see the held
        set *before* the event.  Returns the direct summary of the walk
        (also used to build leak/release effect summaries)."""
        mod = self.module_of(ff)
        graph = self.graph
        direct = _Direct()
        held: List[Tuple[str, int]] = []

        def emit_acquire(lid: str, line: int) -> None:
            if on_acquire:
                on_acquire(lid, line, tuple(held))
            direct.acquires.setdefault(lid, line)
            held.append((lid, line))

        def emit_release(lid: str) -> None:
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] == lid:
                    del held[i]
                    return
            direct.released_extra.add(lid)

        def handle_call(call: ast.Call) -> None:
            func = call.func
            if isinstance(func, ast.Attribute) and func.attr in ("acquire", "release"):
                lid = graph.lock_id(func.value, ff, mod)
                if lid is not None:
                    if func.attr == "acquire":
                        emit_acquire(lid, call.lineno)
                    else:
                        emit_release(lid)
                    return
            name = callee_name(func)
            if name in BLOCKING_CALLS and not _timeout_exempt(call, name):
                direct.blocking.append((name, call.lineno))
            targets = graph.resolve_call(call, ff, mod)
            for t in targets:
                direct.calls.append((call.lineno, t))
            if on_call:
                on_call(call, targets, tuple(held))
            # apply callee leak/release effects (split acquire helpers)
            for t in targets:
                if t.qualid == ff.qualid:
                    continue
                eff = self.direct(t)
                for lid in eff.leaked:
                    emit_acquire(lid, call.lineno)
                for lid in eff.released_extra:
                    emit_release(lid)

        def scan_expr(node: Optional[ast.AST]) -> None:
            if node is None:
                return
            stack: List[ast.AST] = [node]
            calls: List[ast.Call] = []
            while stack:
                n = stack.pop()
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    continue  # deferred execution
                if isinstance(n, ast.Call):
                    calls.append(n)
                stack.extend(ast.iter_child_nodes(n))
            for c in reversed(calls):  # roughly source order
                handle_call(c)

        def merge_from(snapshot: List[Tuple[str, int]]) -> None:
            have = {l for l, _ in held}
            for entry in snapshot:
                if entry[0] not in have:
                    held.append(entry)

        def terminates(stmts: List[ast.stmt]) -> bool:
            """Whether control cannot fall off the end of this block — a
            branch that returns must not leak its held-set into the
            fall-through path (the try-acquire-then-return idiom)."""
            return bool(stmts) and isinstance(
                stmts[-1], (ast.Return, ast.Raise, ast.Break, ast.Continue)
            )

        def do_body(stmts: List[ast.stmt]) -> None:
            for s in stmts:
                do_stmt(s)

        def do_stmt(s: ast.stmt) -> None:
            if isinstance(s, (ast.With, ast.AsyncWith)):
                entered = []
                for item in s.items:
                    scan_expr(item.context_expr)
                    lid = graph.lock_id(item.context_expr, ff, mod)
                    if lid is not None:
                        emit_acquire(lid, s.lineno)
                        entered.append(lid)
                do_body(s.body)
                for lid in reversed(entered):
                    emit_release(lid)
            elif isinstance(s, ast.If):
                scan_expr(s.test)
                snap = list(held)
                do_body(s.body)
                after_body = list(held)
                body_term = terminates(s.body)
                held[:] = snap
                do_body(s.orelse)
                orelse_term = bool(s.orelse) and terminates(s.orelse)
                if body_term and not orelse_term:
                    pass  # fall-through comes only from the else path
                elif orelse_term and not body_term:
                    held[:] = after_body
                elif not body_term:
                    merge_from(after_body)
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                scan_expr(s.iter)
                snap = list(held)
                do_body(s.body)
                merge_from(snap)
                do_body(s.orelse)
            elif isinstance(s, ast.While):
                scan_expr(s.test)
                snap = list(held)
                do_body(s.body)
                merge_from(snap)
                do_body(s.orelse)
            elif isinstance(s, ast.Try):
                do_body(s.body)
                for h in s.handlers:
                    do_body(h.body)
                do_body(s.orelse)
                do_body(s.finalbody)
            elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                pass  # nested definitions: deferred execution
            else:
                scan_expr(s)

        do_body(ff.node.body)
        for lid, line in held:
            direct.leaked.setdefault(lid, line)
        return direct

    # ------------------------------------------------------ direct summaries
    def direct(self, ff: FunctionFacts) -> _Direct:
        qid = ff.qualid
        cached = self._direct.get(qid)
        if cached is not None:
            return cached
        if qid in self._building:  # recursion cycle: empty effects
            return _Direct()
        self._building.add(qid)
        try:
            summary = self.walk(ff)
        finally:
            self._building.discard(qid)
        self._direct[qid] = summary
        return summary

    # --------------------------------------------------- transitive closures
    def trans_acquires(self, ff: FunctionFacts, _stack: Optional[Set[str]] = None) -> Dict[str, List[str]]:
        """lock id -> witness chain (``file:line qualname`` steps) for
        every lock ``ff`` may acquire, transitively."""
        qid = ff.qualid
        if qid in self._trans_acq:
            return self._trans_acq[qid]
        stack = _stack if _stack is not None else set()
        if qid in stack:
            return {}
        stack.add(qid)
        mod = self.module_of(ff)
        d = self.direct(ff)
        out: Dict[str, List[str]] = {}
        for lid, line in d.acquires.items():
            out.setdefault(lid, [f"{_loc(mod, line)} {ff.qualname} acquires {lid}"])
        for line, callee in d.calls:
            for lid, chain in self.trans_acquires(callee, stack).items():
                if lid not in out and len(chain) < 6:
                    out[lid] = [f"{_loc(mod, line)} {ff.qualname} calls {callee.qualname}"] + chain
        stack.discard(qid)
        self._trans_acq[qid] = out
        return out

    def trans_blocking(self, ff: FunctionFacts, _stack: Optional[Set[str]] = None) -> List[Tuple[str, List[str]]]:
        """(blocking-call name, witness chain) for every blocking call
        ``ff`` may reach, transitively (one representative per name)."""
        qid = ff.qualid
        if qid in self._trans_blk:
            return self._trans_blk[qid]
        stack = _stack if _stack is not None else set()
        if qid in stack:
            return []
        stack.add(qid)
        mod = self.module_of(ff)
        d = self.direct(ff)
        out: Dict[str, List[str]] = {}
        for name, line in d.blocking:
            out.setdefault(name, [f"{_loc(mod, line)} {ff.qualname} calls {name}()"])
        for line, callee in d.calls:
            for name, chain in self.trans_blocking(callee, stack):
                if name not in out and len(chain) < 6:
                    out[name] = [f"{_loc(mod, line)} {ff.qualname} calls {callee.qualname}"] + chain
        stack.discard(qid)
        result = sorted(out.items())
        self._trans_blk[qid] = result
        return result


def get_lock_model(ctx: AnalysisContext) -> LockModel:
    return ctx.extra("lock_model", lambda: LockModel(ctx))


# ============================================================ pass 1: order
@analysis_pass("lock-order", "inter-procedural lock-acquisition graph: fail on cycles")
def lock_order(ctx: AnalysisContext) -> List[Finding]:
    model = get_lock_model(ctx)
    edges: Dict[Tuple[str, str], Dict[str, object]] = {}

    for mod, ff in ctx.iter_functions(LOCK_SCOPE):

        def on_acquire(lid, line, held, mod=mod, ff=ff):
            for h, _hl in held:
                edges.setdefault(
                    (h, lid),
                    {
                        "file": mod.path or mod.name,
                        "line": line,
                        "witness": f"{_loc(mod, line)} {ff.qualname} acquires {lid} while holding {h}",
                    },
                )

        def on_call(call, targets, held, mod=mod, ff=ff):
            if not held:
                return
            for t in targets:
                for lid, chain in model.trans_acquires(t).items():
                    for h, _hl in held:
                        edges.setdefault(
                            (h, lid),
                            {
                                "file": mod.path or mod.name,
                                "line": call.lineno,
                                "witness": f"{_loc(mod, call.lineno)} {ff.qualname} (holding {h}) -> "
                                + " -> ".join(chain),
                            },
                        )

        model.walk(ff, on_acquire, on_call)

    findings: List[Finding] = []
    # self-loops: re-acquiring a non-reentrant lock identity while held
    adj: Dict[str, Set[str]] = {}
    for (a, b), info in edges.items():
        if a == b:
            findings.append(
                Finding(
                    pass_id="lock-order",
                    file=str(info["file"]),
                    line=int(info["line"]),  # type: ignore[arg-type]
                    message=f"lock {a} re-acquired while already held (non-reentrant; "
                    "or hand-over-hand across instances of one class without a total order)",
                    key=f"self-cycle:{a}",
                    witness=(str(info["witness"]),),
                )
            )
        else:
            adj.setdefault(a, set()).add(b)

    # cycle detection: DFS with colors, report each cycle once
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {n: WHITE for n in set(adj) | {b for bs in adj.values() for b in bs}}
    path: List[str] = []
    reported: Set[Tuple[str, ...]] = set()

    def dfs(n: str) -> None:
        color[n] = GRAY
        path.append(n)
        for m in sorted(adj.get(n, ())):
            if color[m] == GRAY:
                cyc = path[path.index(m) :] + [m]
                locks = cyc[:-1]
                rot = locks.index(min(locks))
                canon = tuple(locks[rot:] + locks[:rot])
                if canon in reported:
                    continue
                reported.add(canon)
                witness = tuple(
                    str(edges[(cyc[i], cyc[i + 1])]["witness"]) for i in range(len(cyc) - 1)
                )
                info = edges[(cyc[0], cyc[1])]
                findings.append(
                    Finding(
                        pass_id="lock-order",
                        file=str(info["file"]),
                        line=int(info["line"]),  # type: ignore[arg-type]
                        message="lock-order cycle (potential deadlock): "
                        + " -> ".join(cyc),
                        key="cycle:" + "->".join(canon),
                        witness=witness,
                    )
                )
            elif color[m] == WHITE:
                dfs(m)
        path.pop()
        color[n] = BLACK

    for n in sorted(color):
        if color[n] == WHITE:
            dfs(n)
    return findings


# ======================================================= pass 2: blocking
@analysis_pass("blocking-under-lock", "no blocking/unbounded call while holding a lock")
def blocking_under_lock(ctx: AnalysisContext) -> List[Finding]:
    model = get_lock_model(ctx)
    findings: List[Finding] = []
    seen: Set[str] = set()

    def add(f: Finding) -> None:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            findings.append(f)

    for mod, ff in ctx.iter_functions(LOCK_SCOPE):

        def on_call(call, targets, held, mod=mod, ff=ff):
            if not held:
                return
            locks = ",".join(sorted({h for h, _ in held}))
            name = callee_name(call.func)
            if name in BLOCKING_CALLS and not _timeout_exempt(call, name):
                add(
                    Finding(
                        pass_id="blocking-under-lock",
                        file=mod.path or mod.name,
                        line=call.lineno,
                        message=f"{ff.qualname} calls {name}() while holding [{locks}] "
                        "— a blocked holder starves every peer on the lock (§5.3)",
                        key=f"{ff.qualname}:{name}:{locks}",
                        witness=(f"{_loc(mod, call.lineno)} {ff.qualname} holds [{locks}]",),
                    )
                )
                return
            for t in targets:
                blk = model.trans_blocking(t)
                if not blk:
                    continue
                bname, chain = blk[0]
                add(
                    Finding(
                        pass_id="blocking-under-lock",
                        file=mod.path or mod.name,
                        line=call.lineno,
                        message=f"{ff.qualname} holds [{locks}] across a call to "
                        f"{t.qualname}, which can reach {bname}()",
                        key=f"{ff.qualname}->{t.qualname}:{bname}:{locks}",
                        witness=tuple(
                            [f"{_loc(mod, call.lineno)} {ff.qualname} holds [{locks}]"] + chain
                        ),
                    )
                )

        model.walk(ff, None, on_call)
    return findings


# =================================================== pass 3: PostStatus
@analysis_pass("unchecked-post-status", "every posting verb's PostStatus must be observed")
def unchecked_post_status(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []

    def visit(body: List[ast.stmt], mod: ModuleFacts, qual: str) -> None:
        for s in body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                inner = f"{qual}.{s.name}" if qual else s.name
                visit(s.body, mod, inner)
                continue
            if isinstance(s, ast.Expr) and isinstance(s.value, ast.Call):
                name = callee_name(s.value.func)
                if name in POST_STATUS_VERBS:
                    findings.append(
                        Finding(
                            pass_id="unchecked-post-status",
                            file=mod.path or mod.name,
                            line=s.lineno,
                            message=f"{qual or mod.name}: return value of {name}() discarded "
                            "— an unobserved EAGAIN is a silently dropped parcel",
                            key=f"{qual}:{name}",
                        )
                    )
            for sub in ast.iter_child_nodes(s):
                if isinstance(sub, ast.stmt):
                    pass
            # recurse into nested statement bodies (if/for/while/with/try)
            for field_name in ("body", "orelse", "finalbody"):
                nested = getattr(s, field_name, None)
                if isinstance(nested, list) and nested and isinstance(nested[0], ast.stmt):
                    visit(nested, mod, qual)
            for h in getattr(s, "handlers", []) or []:
                visit(h.body, mod, qual)

    for mod in ctx.modules.values():
        visit(mod.tree.body, mod, "")
    return findings


# ============================================== pass 4: capability dominance
_CAP_ALLOW = (
    "src/repro_torch/core/comm/",
    "src/repro_torch/core/device.py",
    "src/repro_torch/core/mpi_sim.py",
)
_BACKENDS = ("LCIDevice", "ShmemComm", "ShmemDevice", "CollectiveComm", "MPISim")


def _taint_polarity(test: ast.AST, tainted: Set[str]) -> Optional[str]:
    """'pos' if the branch test asserts a capability-derived truth at top
    level, 'neg' if it asserts its negation, None if the test never
    mentions the taint."""

    def mentions(n: ast.AST) -> bool:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Attribute) and (
                sub.attr in tainted or sub.attr == "one_sided_put"
            ):
                return True
            if isinstance(sub, ast.Name) and sub.id in tainted:
                return True
        return False

    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return "neg" if mentions(test.operand) else None
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            p = _taint_polarity(v, tainted)
            if p is not None:
                return p
        return None
    return "pos" if mentions(test) else None


@analysis_pass("capability-dominance", "every put site dominated by a one_sided_put check")
def capability_dominance(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.modules.values():
        path = mod.path or ""
        if path.startswith("src/repro_torch/") and any(
            path.startswith(a) or path == a for a in _CAP_ALLOW
        ):
            continue
        tainted: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and any(
                isinstance(n, ast.Attribute) and n.attr == "one_sided_put"
                for n in ast.walk(node.value)
            ):
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        tainted.add(tgt.attr)
                    elif isinstance(tgt, ast.Name):
                        tainted.add(tgt.id)

        put_sites: List[Tuple[ast.Call, bool, str]] = []  # (call, dominated, qual)

        def scan_expr(node: ast.AST, guards: List[Tuple[ast.AST, str]], qual: str) -> None:
            if isinstance(node, ast.IfExp):
                scan_expr(node.test, guards, qual)
                scan_expr(node.body, guards + [(node.test, "body")], qual)
                scan_expr(node.orelse, guards + [(node.test, "orelse")], qual)
                return
            if isinstance(node, ast.Call):
                if callee_name(node.func) == "post_put_signal":
                    dominated = any(
                        (_taint_polarity(t, tainted) == "pos" and br == "body")
                        or (_taint_polarity(t, tainted) == "neg" and br == "orelse")
                        for t, br in guards
                    )
                    put_sites.append((node, dominated, qual))
            for child in ast.iter_child_nodes(node):
                scan_expr(child, guards, qual)

        def visit(body: List[ast.stmt], guards: List[Tuple[ast.AST, str]], qual: str) -> None:
            for s in body:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    visit(s.body, guards, f"{qual}.{s.name}" if qual else s.name)
                elif isinstance(s, ast.If):
                    scan_expr(s.test, guards, qual)
                    visit(s.body, guards + [(s.test, "body")], qual)
                    visit(s.orelse, guards + [(s.test, "orelse")], qual)
                elif isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
                    for attr in ("iter", "test"):
                        sub = getattr(s, attr, None)
                        if sub is not None:
                            scan_expr(sub, guards, qual)
                    visit(s.body, guards, qual)
                    visit(s.orelse, guards, qual)
                elif isinstance(s, (ast.With, ast.AsyncWith)):
                    for item in s.items:
                        scan_expr(item.context_expr, guards, qual)
                    visit(s.body, guards, qual)
                elif isinstance(s, ast.Try):
                    visit(s.body, guards, qual)
                    for h in s.handlers:
                        visit(h.body, guards, qual)
                    visit(s.orelse, guards, qual)
                    visit(s.finalbody, guards, qual)
                else:
                    scan_expr(s, guards, qual)

        visit(mod.tree.body, [], "")
        for call, dominated, qual in put_sites:
            if not dominated:
                findings.append(
                    Finding(
                        pass_id="capability-dominance",
                        file=mod.path or mod.name,
                        line=call.lineno,
                        message=f"{qual or mod.name}: post_put_signal() not dominated by a "
                        "one_sided_put capability check — the put path must be selected "
                        "from the advertised Capabilities (§2.3)",
                        key=f"{qual}:undominated-put",
                    )
                )
    return findings


# =============================================== pass 5: thread ownership
_THREAD_EXEMPT = ("core/comm/membership.py", "launch/serve.py")


@analysis_pass("thread-ownership", "worker threads spawn only via the membership nursery")
def thread_ownership(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.modules.values():
        path = mod.path or mod.name
        if any(path.endswith(e) for e in _THREAD_EXEMPT):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and ctx.graph.resolves_to(node, mod, "threading.Thread"):
                findings.append(
                    Finding(
                        pass_id="thread-ownership",
                        file=path,
                        line=node.lineno,
                        message=f"{path}: spawns a raw threading.Thread — worker lifecycle "
                        "belongs to membership.spawn_worker / ProgressWorkerPool "
                        "(the census must see every worker)",
                        key=f"raw-thread:{node.lineno // 1000}",  # near-stable bucket
                    )
                )

    # callgraph-backed wiring: the big thread consumers must ride the nursery
    def calls_into(mod: ModuleFacts, target_suffix: str) -> bool:
        for ff in mod.functions.values():
            for node in ast.walk(ff.node):
                if isinstance(node, ast.Call):
                    for t in ctx.graph.resolve_call(node, ff, mod):
                        if t.qualid.endswith(target_suffix):
                            return True
        return False

    def references(mod: ModuleFacts, name: str) -> bool:
        if any(t.rsplit(".", 1)[-1] == name for t in mod.import_aliases.values()):
            return True
        return any(
            isinstance(n, (ast.Name,)) and n.id == name for n in ast.walk(mod.tree)
        )

    executor = ctx.module_at("core/executor.py")
    if executor is not None:
        for needle in ("membership:spawn_worker", "membership:join_workers"):
            if not calls_into(executor, needle):
                findings.append(
                    Finding(
                        pass_id="thread-ownership",
                        file=executor.path or executor.name,
                        line=1,
                        message=f"core/executor.py: no resolved call to {needle.split(':')[1]} "
                        "— worker threads must go through the one nursery",
                        key=f"missing:{needle}",
                    )
                )
    lci_pp = ctx.module_at("core/lci_parcelport.py")
    if lci_pp is not None and not references(lci_pp, "ProgressWorkerPool"):
        findings.append(
            Finding(
                pass_id="thread-ownership",
                file=lci_pp.path or lci_pp.name,
                line=1,
                message="core/lci_parcelport.py: does not use membership.ProgressWorkerPool "
                "— dedicated progress threads must come from the pool",
                key="missing:ProgressWorkerPool",
            )
        )
    return findings
