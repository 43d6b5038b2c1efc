"""The eight API gates, on the shared analysis infrastructure.

Gates 1–3 stay *runtime* checks (they probe live dataclasses — mirrored
fields, shared ``limits`` identity, delegate wiring — which no AST can
see); they import lazily and skip cleanly on fixture contexts.  Gates
4–8 become AST passes over the shared :class:`ModuleFacts`, which fixes
the two fragilities the old line-greps had:

* **aliased imports** — ``from ..completion import LCRQueue as Q; Q()``
  and ``from ..device import LCIDevice as Dev; isinstance(x, Dev)`` now
  resolve through the per-module import-alias map;
* **multi-line calls** — the AST sees one ``Call`` node no matter how
  the formatter wrapped it, where ``"isinstance(" in line`` looked at
  one physical line and missed the type argument on the next.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .facts import ModuleFacts
from .registry import AnalysisContext, Finding, analysis_pass

__all__ = ["BACKEND_NAMES"]

BACKEND_NAMES = ("LCIDevice", "ShmemComm", "ShmemDevice", "CollectiveComm", "MPISim")


# ------------------------------------------------------------------ helpers
def _find(pass_id: str, mod_or_file, line: int, message: str, key: str) -> Finding:
    file = mod_or_file if isinstance(mod_or_file, str) else (mod_or_file.path or mod_or_file.name)
    return Finding(pass_id=pass_id, file=file, line=line, message=message, key=key)


def _identifier_used(mod: ModuleFacts, name: str) -> bool:
    """Whether ``name`` appears as an identifier anywhere in the module:
    a bare name, an attribute, a def, or an import target."""
    if name in mod.import_aliases:
        return True
    if any(t.rsplit(".", 1)[-1] == name for t in mod.import_aliases.values()):
        return True
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Name) and node.id == name:
            return True
        if isinstance(node, ast.Attribute) and node.attr == name:
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and node.name == name:
            return True
    return False


def _resolved_name(expr: ast.AST, mod: ModuleFacts) -> Optional[str]:
    """The terminal class name an expression denotes, chasing import
    aliases: ``Dev`` (``from x import LCIDevice as Dev``) → ``LCIDevice``;
    ``device.LCIDevice`` → ``LCIDevice``."""
    if isinstance(expr, ast.Name):
        target = mod.import_aliases.get(expr.id)
        if target:
            return target.rsplit(".", 1)[-1]
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _attr_calls(mod: ModuleFacts, attr: str) -> Iterable[ast.Call]:
    for node in ast.walk(mod.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == attr
        ):
            yield node


def _is_real_repo(ctx: AnalysisContext) -> bool:
    """Runtime gates only make sense against the actual repo (fixture
    contexts built from synthetic sources skip them)."""
    return ctx.module_at("core/comm/resources.py") is not None


def _runtime_api(ctx: AnalysisContext):
    """Import the live config surface once per context (gates 1–3 share
    it).  Returns the module tuple or an error string."""

    def build():
        import sys
        from pathlib import Path

        sys.path.insert(0, str(ctx.root / "src"))
        try:
            from repro_torch.amtsim.parcelport_sim import SimConfig, sim_config_for_variant
            from repro_torch.core.comm.resources import ResourceLimits
            from repro_torch.core.fabric import Fabric
            from repro_torch.core.lci_parcelport import LCIPPConfig
            from repro_torch.core.variants import VARIANTS
        except Exception as exc:  # pragma: no cover - environment-dependent
            return f"import failed: {exc}"
        return (SimConfig, sim_config_for_variant, ResourceLimits, Fabric, LCIPPConfig, VARIANTS)

    return ctx.extra("runtime_api", build)


# ======================================================= gates 1–3 (runtime)
@analysis_pass("gate-resource-mirror", "no config dataclass re-grows ResourceLimits fields")
def gate_resource_mirror(ctx: AnalysisContext) -> List[Finding]:
    if not _is_real_repo(ctx):
        return []
    api = _runtime_api(ctx)
    if isinstance(api, str):
        return [_find("gate-resource-mirror", "", 0, api, "import-failed")]
    SimConfig, _, ResourceLimits, _, LCIPPConfig, _ = api
    out: List[Finding] = []
    limit_fields = {f.name for f in dataclasses.fields(ResourceLimits)}
    for cfg_cls in (SimConfig, LCIPPConfig):
        dup = limit_fields & {f.name for f in dataclasses.fields(cfg_cls)}
        if dup:
            out.append(
                _find(
                    "gate-resource-mirror",
                    "",
                    0,
                    f"{cfg_cls.__name__} duplicates ResourceLimits fields {sorted(dup)} "
                    "(use the shared `limits` object, not mirrored fields)",
                    f"mirror:{cfg_cls.__name__}",
                )
            )
    return out


@analysis_pass("gate-resource-shared", "every layer consumes the ONE ResourceLimits object")
def gate_resource_shared(ctx: AnalysisContext) -> List[Finding]:
    if not _is_real_repo(ctx):
        return []
    api = _runtime_api(ctx)
    if isinstance(api, str):
        return [_find("gate-resource-shared", "", 0, api, "import-failed")]
    SimConfig, sim_config_for_variant, ResourceLimits, Fabric, LCIPPConfig, VARIANTS = api
    out: List[Finding] = []
    for cfg_cls in (SimConfig, LCIPPConfig):
        names = {f.name for f in dataclasses.fields(cfg_cls)}
        if "limits" not in names:
            out.append(
                _find("gate-resource-shared", "", 0,
                      f"{cfg_cls.__name__} has no `limits: ResourceLimits` field",
                      f"no-limits:{cfg_cls.__name__}")
            )
        elif not isinstance(cfg_cls().limits, ResourceLimits):
            out.append(
                _find("gate-resource-shared", "", 0,
                      f"{cfg_cls.__name__}().limits is not a ResourceLimits",
                      f"bad-limits:{cfg_cls.__name__}")
            )
    lim = ResourceLimits(send_queue_depth=3, bounce_buffers=2, bounce_buffer_size=4096)
    fab = Fabric(2, limits=lim)
    if getattr(fab, "limits", None) is not lim:
        out.append(
            _find("gate-resource-shared", "", 0,
                  "Fabric does not expose the ResourceLimits it was built with",
                  "fabric-limits")
        )
    if fab.device(0).send_queue_depth != 3:
        out.append(
            _find("gate-resource-shared", "", 0,
                  "Fabric devices ignore limits.send_queue_depth", "fabric-depth")
        )
    try:
        functional = VARIANTS["lci_b8"].limits
        des = sim_config_for_variant("lci_b8").limits
        if functional != des:
            out.append(
                _find("gate-resource-shared", "", 0,
                      f"lci_b8: functional limits {functional} != DES limits {des} "
                      "(the two layers drifted)", "lci_b8-drift")
            )
    except KeyError:
        out.append(
            _find("gate-resource-shared", "", 0,
                  "parameterized family member lci_b8 failed to resolve", "lci_b8-missing")
        )
    return out


@analysis_pass("gate-resource-delegates", "legacy knob names read through to the shared limits")
def gate_resource_delegates(ctx: AnalysisContext) -> List[Finding]:
    if not _is_real_repo(ctx):
        return []
    api = _runtime_api(ctx)
    if isinstance(api, str):
        return [_find("gate-resource-delegates", "", 0, api, "import-failed")]
    SimConfig, _, ResourceLimits, _, LCIPPConfig, _ = api
    out: List[Finding] = []
    probe = SimConfig(limits=ResourceLimits(send_queue_depth=7, bounce_buffers=5,
                                            bounce_buffer_size=1234, retry_budget=9,
                                            recv_slots=6))
    for knob, want in (("send_queue_depth", 7), ("bounce_buffers", 5),
                       ("bounce_buffer_size", 1234), ("retry_budget", 9),
                       ("recv_slots", 6)):
        if getattr(probe, knob, None) != want:
            out.append(
                _find("gate-resource-delegates", "", 0,
                      f"SimConfig.{knob} does not delegate to limits.{knob}",
                      f"sim-delegate:{knob}")
            )
    if LCIPPConfig(limits=ResourceLimits(retry_budget=3)).retry_budget != 3:
        out.append(
            _find("gate-resource-delegates", "", 0,
                  "LCIPPConfig.retry_budget does not delegate to limits.retry_budget",
                  "lcipp-delegate:retry_budget")
        )
    return out


# ========================================================= gate 4 (engine)
_POLL_CQ_ALLOWED = ("core/fabric.py", "core/device.py")
_DES_FORBIDDEN = ("_lci_background_work", "_mpi_background_work", "_progress_device")


@analysis_pass("gate-progress-engine", "completions reaped only by the ONE ProgressEngine")
def gate_progress_engine(ctx: AnalysisContext) -> List[Finding]:
    out: List[Finding] = []
    pid = "gate-progress-engine"
    # 4a. poll_cq stays behind the CommInterface progress verb
    for mod in ctx.modules.values():
        path = mod.path or mod.name
        if any(path.endswith(a) for a in _POLL_CQ_ALLOWED):
            continue
        for call in _attr_calls(mod, "poll_cq"):
            out.append(
                _find(pid, mod, call.lineno,
                      f"{path}: calls poll_cq — the hardware reap verb belongs to "
                      "the engine's backend adapters only", "poll_cq")
            )
            break  # one finding per module, like the old gate
    # 4b. both functional parcelports drive the ONE engine
    for suffix, cls_name in (("core/lci_parcelport.py", "LCIParcelport"),
                             ("core/mpi_parcelport.py", "MPIParcelport")):
        mod = ctx.module_at(suffix)
        if mod is None:
            continue
        cf = mod.classes.get(cls_name)
        if cf is not None:
            bw = None
            for c in ctx.graph.mro(cf):
                if "background_work" in c.methods:
                    bw = c.methods["background_work"]
                    break
            if bw is not None and not any(
                isinstance(n, ast.Call)
                and (isinstance(n.func, ast.Attribute) and n.func.attr == "run_step"
                     or isinstance(n.func, ast.Name) and n.func.id == "run_step")
                for n in ast.walk(bw.node)
            ):
                out.append(
                    _find(pid, mod, bw.node.lineno,
                          f"{cls_name}.background_work does not call the shared engine "
                          "(run_step) — private progress loop re-grown?",
                          f"thin-bw:{cls_name}")
                )
        if not _identifier_used(mod, "ProgressEngine"):
            out.append(
                _find(pid, mod, 1,
                      f"{mod.path}: does not import the shared ProgressEngine",
                      "no-engine-import")
            )
        for call in _attr_calls(mod, "drain"):
            out.append(
                _find(pid, mod, call.lineno,
                      f"{mod.path}: drains a completion queue directly — reaping "
                      "belongs to the engine's reap op", "drain")
            )
            break
    # 4c. the DES has no backend-specific background-work generators
    sim = ctx.module_at("amtsim/parcelport_sim.py")
    if sim is not None:
        if not _identifier_used(sim, "ProgressEngine"):
            out.append(
                _find(pid, sim, 1,
                      "parcelport_sim.py does not import the shared ProgressEngine",
                      "des-no-engine")
            )
        for forbidden in _DES_FORBIDDEN:
            if _identifier_used(sim, forbidden):
                out.append(
                    _find(pid, sim, 1,
                          f"parcelport_sim.py re-grew {forbidden} — the DES must drive "
                          "the shared engine, not duplicate its loop",
                          f"des-regrown:{forbidden}")
                )
        call_sites = [
            n for n in ast.walk(sim.tree)
            if isinstance(n, ast.Call)
            and (isinstance(n.func, ast.Attribute) and n.func.attr == "_handle_completion"
                 or isinstance(n.func, ast.Name) and n.func.id == "_handle_completion")
        ]
        if len(call_sites) > 1:
            out.append(
                _find(pid, sim, call_sites[1].lineno,
                      f"parcelport_sim.py calls _handle_completion from "
                      f"{len(call_sites)} sites — dispatch-by-kind belongs to the "
                      "engine driver alone", "des-handle-completion")
            )
    return out


# ========================================================= gate 5 (serving)
_QUEUE_CTORS = ("LCRQueue", "MichaelScottQueue", "LockQueue")
_SERVE_SCOPE_SUFFIXES = ("core/executor.py", "launch/serve.py")


@analysis_pass("gate-serving-comm", "serving hand-off rides the shared comm layer")
def gate_serving_comm(ctx: AnalysisContext) -> List[Finding]:
    out: List[Finding] = []
    pid = "gate-serving-comm"
    server = ctx.module_at("serve/server.py")
    if server is not None:
        for needle, why in (
            ("CommChannel", "requests/responses must ride the comm layer's channel"),
            ("ProgressEngine", "the engine loop must be the ONE shared ProgressEngine"),
            ("run_step", "the serve loop must drive the engine's canonical step"),
        ):
            if not _identifier_used(server, needle):
                out.append(
                    _find(pid, server, 1,
                          f"src/repro_torch/serve/server.py: {needle} missing — {why}",
                          f"server-needle:{needle}")
                )
        if not any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and n.func.attr == "for_config"
            and _resolved_name(n.func.value, server) == "ProgressPolicy"
            for n in ast.walk(server.tree)
        ):
            out.append(
                _find(pid, server, 1,
                      "src/repro_torch/serve/server.py: ProgressPolicy.for_config missing — "
                      "the policy must come from the shared builder",
                      "server-needle:ProgressPolicy.for_config")
            )
    executor = ctx.module_at("core/executor.py")
    if executor is not None and not _identifier_used(executor, "run_step"):
        out.append(
            _find(pid, executor, 1,
                  "src/repro_torch/core/executor.py: the idle pump does not drive the "
                  "shared engine (run_step) — opaque private pump re-grown?",
                  "executor-run_step")
        )
    # 5b. no private hand-off machinery beside it (alias-aware)
    scoped = [
        m for m in ctx.modules.values()
        if (m.path or "").startswith("src/repro_torch/serve/")
        or any((m.path or m.name).endswith(s) for s in _SERVE_SCOPE_SUFFIXES)
    ]
    for mod in scoped:
        path = mod.path or mod.name
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                ctor = _resolved_name(node.func, mod)
                if ctor in _QUEUE_CTORS:
                    out.append(
                        _find(pid, mod, node.lineno,
                              f"{path}: constructs {ctor} — completion queues belong "
                              "behind the comm layer", f"queue-ctor:{ctor}")
                    )
                elif isinstance(node.func, ast.Attribute) and node.func.attr in ("isend", "irecv"):
                    out.append(
                        _find(pid, mod, node.lineno,
                              f"{path}: calls .{node.func.attr}( — the MPI veneer "
                              "bypasses the unified interface",
                              f"mpi-veneer:{node.func.attr}")
                    )
        for pump in ("_send_loop", "_recv_loop"):
            if _identifier_used(mod, pump):
                out.append(
                    _find(pid, mod, 1,
                          f"{path}: contains {pump} — private hand-off loop re-grown",
                          f"pump:{pump}")
                )
    return out


# ===================================================== gate 6 (capability)
_CAP_ALLOW = (
    "src/repro_torch/core/comm/",
    "src/repro_torch/core/device.py",
    "src/repro_torch/core/mpi_sim.py",
)


@analysis_pass("gate-put-capability", "put-path selection by advertised Capabilities only")
def gate_put_capability(ctx: AnalysisContext) -> List[Finding]:
    out: List[Finding] = []
    pid = "gate-put-capability"
    for mod in ctx.modules.values():
        path = mod.path or ""
        if path.startswith("src/repro_torch/") and any(
            path.startswith(a) or path == a for a in _CAP_ALLOW
        ):
            continue
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance"
                and len(node.args) == 2
            ):
                continue
            type_arg = node.args[1]
            candidates = list(type_arg.elts) if isinstance(type_arg, ast.Tuple) else [type_arg]
            hit = next(
                (n for n in (_resolved_name(c, mod) for c in candidates) if n in BACKEND_NAMES),
                None,
            )
            if hit:
                out.append(
                    _find(pid, mod, node.lineno,
                          f"{mod.path or mod.name}: isinstance() against concrete comm "
                          f"backend {hit} — select the put path from "
                          "capabilities.one_sided_put, not the backend type",
                          f"isinstance:{hit}")
                )
        posts_put = any(True for _ in _attr_calls(mod, "post_put_signal"))
        if posts_put and not _identifier_used(mod, "one_sided_put"):
            out.append(
                _find(pid, mod, 1,
                      f"{mod.path or mod.name}: posts one-sided puts without consulting "
                      "capabilities.one_sided_put — the put path must be selected by "
                      "the advertised Capabilities", "put-no-capability")
            )
    return out


# ======================================================= gate 7 (nursery)
@analysis_pass("gate-thread-nursery", "worker threads only via the membership nursery")
def gate_thread_nursery(ctx: AnalysisContext) -> List[Finding]:
    """Gate 7, rebuilt on the call graph: delegates to the
    thread-ownership pass (alias-aware ``threading.Thread`` resolution +
    resolved-call wiring checks) and re-tags the findings so the gate
    keeps its own stable fingerprint namespace."""
    from .passes import thread_ownership

    return [
        Finding(pass_id="gate-thread-nursery", file=f.file, line=f.line,
                message=f.message, key=f.key, witness=f.witness)
        for f in thread_ownership(ctx)
    ]


# ======================================================== gate 8 (pickle)
_WIRE_SCOPE = (
    "src/repro_torch/train/grad_sync.py",
    "src/repro_torch/core/comm/",
    "src/repro_torch/serve/",
)


@analysis_pass("gate-no-pickle-wire", "wire-path modules never touch pickle")
def gate_no_pickle_wire(ctx: AnalysisContext) -> List[Finding]:
    out: List[Finding] = []
    pid = "gate-no-pickle-wire"
    for mod in ctx.modules.values():
        path = mod.path or ""
        if path.startswith("src/repro_torch/") and not any(
            path.startswith(s) or path == s for s in _WIRE_SCOPE
        ):
            continue
        if not path:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "pickle" for a in node.names
            ):
                offender = "import pickle"
            elif isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "pickle":
                offender = "from pickle import"
            elif isinstance(node, ast.Name) and node.id == "pickle":
                offender = "pickle reference"
            else:
                continue
            out.append(
                _find(pid, mod, node.lineno,
                      f"{path}:{node.lineno}: {offender} — wire-path modules must use "
                      "the versioned binary format in core/comm/wire.py "
                      "(encode_msg/decode_msg, grad headers), never pickle",
                      f"pickle:{offender}")
            )
    return out
