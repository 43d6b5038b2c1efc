"""Port parity: the concurrency static-analysis subsystem
(``repro_torch.analysis``) over the port's own tree.

* On every fixture source of ``tests/test_analysis.py`` both packages'
  passes give the same ``(pass_id, line, key, fingerprint, witness)``
  (fixtures the reference places under ``src/repro/`` sit at the same
  path under ``src/repro_torch/`` for the port).
* ``tests/test_analysis.py``'s static half on the port: each known-bad
  fixture is caught with its witness, each clean twin stays quiet, the
  13-pass registry, line-free fingerprints, the aliased-import and
  multi-line-call gate cases, and the CLI (``--strict``, its JSON, an
  unknown pass giving rc 2).
* Over the trees: the port's findings over ``src/repro_torch`` are the
  reference's over ``src/repro`` with ``src/repro/`` read as
  ``src/repro_torch/``, 0 new and 0 stale against
  ``tools/torch_analysis_baseline.json`` (exactly the reference's 8
  entries, paths rewritten).  Seeded violations at port paths are
  caught, so no pass reads a prefix that matches nothing."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import registry as jregistry
from repro_torch.analysis import registry as tregistry
from repro_torch.analysis.registry import (
    AnalysisContext,
    all_passes,
    load_baseline,
    run_passes,
    split_findings,
)
from test_analysis import (
    BLOCKING_CLEAN_SRC,
    BLOCKING_SRC,
    BLOCKING_TRANSITIVE_SRC,
    CAP_SRC,
    CLEAN_ORDER_SRC,
    CYCLE_SRC,
    POST_SRC,
)

REPO = Path(__file__).resolve().parent.parent
PASSES = ("lock-order", "blocking-under-lock", "unchecked-post-status", "capability-dominance", "thread-ownership",
          "gate-resource-mirror", "gate-resource-shared", "gate-resource-delegates", "gate-progress-engine",
          "gate-serving-comm", "gate-put-capability", "gate-thread-nursery", "gate-no-pickle-wire")

# the fixtures tests/test_analysis.py writes inside its tests
TRANSITIVE_CYCLE_SRC = """
    import threading

    class Pair:
        def __init__(self):
            self.l1 = threading.Lock()
            self.l2 = threading.Lock()

        def take_l2(self):
            with self.l2:
                pass

        def forward(self):
            with self.l1:
                self.take_l2()

        def backward(self):
            with self.l2:
                with self.l1:
                    pass
"""
TRY_ACQUIRE_SRC = """
    import threading

    class Dev:
        def __init__(self):
            self.coarse = threading.Lock()

        def _acquire(self, try_only=False):
            if try_only:
                ok = self.coarse.acquire(blocking=False)
                return ok
            self.coarse.acquire()
            return True
"""
CAP_NEGATED_SRC = """
    class Proto:
        def __init__(self, dev):
            self._use_put = dev.capabilities.one_sided_put

        def inverted(self, dev, data):
            if not self._use_put:
                return dev.post_put_signal(0, 0, data, None)
            return dev.post_send(0, 0, 1, data, None)
"""
ROGUE_THREAD_SRC = """
    import threading

    def rogue(fn):
        t = threading.Thread(target=fn)
        t.start()

    def good(membership, fn):
        return membership.spawn_worker(fn)
"""
ALIASED_THREAD_SRC = """
    from threading import Thread as T

    def rogue(fn):
        worker = T(target=fn)
        worker.start()
"""
ALIASED_ISINSTANCE_SRC = """
    from repro.core.device import LCIDevice as Dev

    def pick(dev):
        if isinstance(dev, Dev):
            return "put"
        return "send"
"""
MULTILINE_ISINSTANCE_SRC = (
    "def pick(dev):\n"
    "    if isinstance(\n"
    "        dev,\n"
    "        MPISim,\n"
    "    ):\n"
    "        return 'big-lock'\n"
    "    return 'other'\n"
)
ALIASED_QUEUE_SRC = """
    from repro.core.completion import LCRQueue as Q

    def build():
        return Q()
"""
SERVING_CLEAN_SRC = """
    def build(channel):
        return channel.request(b"x")
"""

# (fixture path in the reference's layout, source), as tests/test_analysis.py places them
FIXTURES = {
    "cycle": ("fx/cycle.py", CYCLE_SRC),
    "clean_order": ("fx/clean.py", CLEAN_ORDER_SRC),
    "transitive_cycle": ("fx/trans.py", TRANSITIVE_CYCLE_SRC),
    "try_acquire": ("fx/tryacq.py", TRY_ACQUIRE_SRC),
    "blocking": ("fx/blk.py", BLOCKING_SRC),
    "blocking_transitive": ("fx/blkt.py", BLOCKING_TRANSITIVE_SRC),
    "blocking_clean": ("fx/blkc.py", BLOCKING_CLEAN_SRC),
    "post_status": ("fx/post.py", POST_SRC),
    "capability": ("fx/cap.py", CAP_SRC),
    "capability_negated": ("fx/capn.py", CAP_NEGATED_SRC),
    "rogue_thread": ("fx/rogue.py", ROGUE_THREAD_SRC),
    "aliased_thread": ("fx/alias.py", ALIASED_THREAD_SRC),
    "aliased_isinstance": ("fx/isal.py", ALIASED_ISINSTANCE_SRC),
    "multiline_isinstance": ("fx/isml.py", MULTILINE_ISINSTANCE_SRC),
    "aliased_queue": ("src/repro/serve/fx_handoff.py", ALIASED_QUEUE_SRC),
    "serving_clean": ("src/repro/serve/fx_clean.py", SERVING_CLEAN_SRC),
}


def _port_path(rel: str) -> str:
    return rel.replace("src/repro/", "src/repro_torch/", 1) if rel.startswith("src/repro/") else rel


def _ctx(registry, sources):
    return registry.AnalysisContext.from_sources({rel: textwrap.dedent(src) for rel, src in sources.items()})


def fixture_ctx(name: str) -> AnalysisContext:
    """The port's context of one fixture, at its port path."""
    rel, src = FIXTURES[name]
    return _ctx(tregistry, {_port_path(rel): src})


def _rows(findings, rewrite=False):
    def fix(s):
        return s.replace("src/repro/", "src/repro_torch/") if rewrite else s

    return sorted((f.pass_id, f.line, fix(f.key), fix(f.fingerprint), tuple(fix(w) for w in f.witness))
                  for f in findings)


def findings_of(ctx, pass_id):
    return run_passes(ctx, [pass_id])


# ====================================================== fixture parity
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_the_reference(name):
    rel, src = FIXTURES[name]
    ref = jregistry.run_passes(_ctx(jregistry, {rel: src}))
    port = tregistry.run_passes(_ctx(tregistry, {_port_path(rel): src}))
    assert _rows(port) == _rows(ref, rewrite=True)


def test_fixtures_produce_findings_in_both_packages():
    """The parity above is not an agreement on nothing: the bad fixtures
    give findings, the clean twins none."""
    quiet = {"clean_order", "try_acquire", "blocking_clean", "serving_clean"}
    for name in FIXTURES:
        n = len(tregistry.run_passes(fixture_ctx(name)))
        assert (n == 0) == (name in quiet), (name, n)


# ===================================================== pass 1: lock order
def test_lock_order_cycle_caught_with_witness():
    found = findings_of(fixture_ctx("cycle"), "lock-order")
    cycles = [f for f in found if f.key.startswith("cycle:")]
    assert len(cycles) == 1, found
    f = cycles[0]
    assert "Pair.l1" in f.message and "Pair.l2" in f.message
    assert len(f.witness) == 2
    assert any("forward" in w for w in f.witness)
    assert any("backward" in w for w in f.witness)


def test_lock_order_clean_twin_quiet():
    assert findings_of(fixture_ctx("clean_order"), "lock-order") == []


def test_lock_order_transitive_cycle_caught():
    found = findings_of(fixture_ctx("transitive_cycle"), "lock-order")
    cycles = [f for f in found if f.key.startswith("cycle:")]
    assert len(cycles) == 1, found
    assert any("take_l2" in w for w in cycles[0].witness)


def test_lock_order_try_acquire_then_return_is_not_a_self_cycle():
    assert findings_of(fixture_ctx("try_acquire"), "lock-order") == []


# ============================================ pass 2: blocking under lock
def test_blocking_under_lock_caught():
    found = findings_of(fixture_ctx("blocking"), "blocking-under-lock")
    assert len(found) == 1 and "sleep" in found[0].message
    assert "Engine.lk" in found[0].message


def test_blocking_under_lock_transitive_with_chain():
    found = findings_of(fixture_ctx("blocking_transitive"), "blocking-under-lock")
    assert len(found) == 1, found
    assert any("_drive" in w for w in found[0].witness)


def test_blocking_under_lock_clean_twin_quiet():
    assert findings_of(fixture_ctx("blocking_clean"), "blocking-under-lock") == []


# ============================================ pass 3: unchecked PostStatus
def test_unchecked_post_status_caught_and_consumers_quiet():
    found = findings_of(fixture_ctx("post_status"), "unchecked-post-status")
    assert len(found) == 1, found
    assert "fire_and_forget" in found[0].message and "post_send" in found[0].message


# ============================================ pass 4: capability dominance
def test_capability_dominance_undominated_put_caught():
    found = findings_of(fixture_ctx("capability"), "capability-dominance")
    assert len(found) == 1, found
    assert "bad" in found[0].key


def test_capability_dominance_wrong_branch_caught():
    assert len(findings_of(fixture_ctx("capability_negated"), "capability-dominance")) == 1


# ============================================== pass 5: thread ownership
def test_thread_ownership_rogue_spawn_caught_and_nursery_quiet():
    found = findings_of(fixture_ctx("rogue_thread"), "thread-ownership")
    assert len(found) == 1 and "threading.Thread" in found[0].message


def test_thread_ownership_catches_aliased_thread():
    plain = textwrap.dedent(ALIASED_THREAD_SRC)
    assert "threading.Thread(" not in plain and "Thread(target=" not in plain
    assert len(findings_of(fixture_ctx("aliased_thread"), "thread-ownership")) == 1


# ===================================== the gates: aliases and wrapped calls
def test_put_capability_gate_catches_aliased_isinstance():
    plain = textwrap.dedent(ALIASED_ISINSTANCE_SRC)
    assert not any("isinstance(" in ln and "LCIDevice" in ln for ln in plain.splitlines())
    found = findings_of(fixture_ctx("aliased_isinstance"), "gate-put-capability")
    assert len(found) == 1 and "LCIDevice" in found[0].message


def test_put_capability_gate_catches_multiline_isinstance():
    assert not any("isinstance(" in ln and "MPISim" in ln for ln in MULTILINE_ISINSTANCE_SRC.splitlines())
    found = findings_of(fixture_ctx("multiline_isinstance"), "gate-put-capability")
    assert len(found) == 1 and "MPISim" in found[0].message


def test_serving_gate_catches_aliased_queue_ctor():
    assert "LCRQueue(" not in textwrap.dedent(ALIASED_QUEUE_SRC)
    found = findings_of(fixture_ctx("aliased_queue"), "gate-serving-comm")
    assert any(f.key == "queue-ctor:LCRQueue" and f.file == "src/repro_torch/serve/fx_handoff.py"
               for f in found), found


def test_serving_gate_clean_twin_quiet():
    assert findings_of(fixture_ctx("serving_clean"), "gate-serving-comm") == []


# ================================================== registry, fingerprints
def test_registry_has_all_thirteen_passes():
    assert set(all_passes()) == set(PASSES) == set(jregistry.all_passes())


def test_fingerprints_are_line_number_free():
    """Moving a function must not invalidate its baseline entry."""
    shifted = "\n\n\n# pushed down\n" + textwrap.dedent(BLOCKING_SRC)
    a = findings_of(fixture_ctx("blocking"), "blocking-under-lock")
    b = findings_of(AnalysisContext.from_sources({"fx/blk.py": shifted}), "blocking-under-lock")
    assert a[0].line != b[0].line
    assert a[0].fingerprint == b[0].fingerprint


# ======================================================== the two trees
@pytest.fixture(scope="module")
def tree_findings():
    port = run_passes(AnalysisContext.for_repo(REPO))
    ref = jregistry.run_passes(jregistry.AnalysisContext.for_repo(REPO))
    return port, ref


def test_port_tree_is_walked_without_the_analyzer():
    ctx = AnalysisContext.for_repo(REPO)
    paths = {m.path for m in ctx.modules.values()}
    assert all(p.startswith("src/repro_torch/") for p in paths)
    assert not any(p.startswith("src/repro_torch/analysis/") for p in paths)
    want = {p.relative_to(REPO).as_posix() for p in (REPO / "src" / "repro_torch").rglob("*.py")
            if "analysis" not in p.relative_to(REPO / "src" / "repro_torch").parts[:1]}
    assert paths == want
    for suffix in ("amtsim/parcelport_sim.py", "core/lci_parcelport.py", "core/executor.py", "serve/server.py"):
        assert ctx.module_at(suffix).path == f"src/repro_torch/{suffix}"


def test_port_tree_findings_equal_the_reference_trees(tree_findings):
    port, ref = tree_findings
    assert sorted(f.fingerprint for f in port) == sorted(
        f.fingerprint.replace(":src/repro/", ":src/repro_torch/", 1) for f in ref)
    assert port and all(f.file.startswith("src/repro_torch/") for f in port)


def test_port_tree_zero_nonbaselined_findings(tree_findings):
    """Every pass over the port's tree: nothing outside the reviewed
    baseline, no stale entries, and the paper's 8 exhibits present."""
    port, _ = tree_findings
    baseline = load_baseline(REPO / "tools" / "torch_analysis_baseline.json")
    new, accepted, stale = split_findings(port, baseline)
    assert new == [], [f.fingerprint for f in new]
    assert stale == [], stale
    assert len(accepted) == len(baseline) == 8


def test_baseline_is_the_references_with_port_paths():
    ref = json.loads((REPO / "tools" / "analysis_baseline.json").read_text())["entries"]
    port = json.loads((REPO / "tools" / "torch_analysis_baseline.json").read_text())["entries"]
    assert port == [{"fingerprint": e["fingerprint"].replace(":src/repro/", ":src/repro_torch/", 1),
                     "reason": e["reason"]} for e in ref]


def test_runtime_gates_import_the_ports_live_config():
    """Gates 1–3 probe the port's own SimConfig, ResourceLimits, Fabric,
    LCIPPConfig and VARIANTS, not the reference's."""
    from repro_torch.amtsim.parcelport_sim import SimConfig
    from repro_torch.analysis.gates import _runtime_api
    from repro_torch.core.variants import VARIANTS

    api = _runtime_api(AnalysisContext.for_repo(REPO))
    assert not isinstance(api, str), api
    assert api[0] is SimConfig and api[5] is VARIANTS
    assert all(getattr(obj, "__module__", "repro_torch").startswith("repro_torch") for obj in api)


SEEDED = {
    # (port path, source, pass, caught?): the scopes are the port's paths
    "blocking in core": ("src/repro_torch/core/fx_seeded.py", BLOCKING_SRC, "blocking-under-lock", True),
    "blocking in amtsim": ("src/repro_torch/amtsim/fx_seeded.py", BLOCKING_SRC, "blocking-under-lock", True),
    "blocking outside the lock scope": ("src/repro_torch/launch/fx_seeded.py", BLOCKING_SRC,
                                        "blocking-under-lock", False),
    "isinstance in serve": ("src/repro_torch/serve/fx_seeded.py", MULTILINE_ISINSTANCE_SRC,
                            "gate-put-capability", True),
    "isinstance in the comm layer": ("src/repro_torch/core/comm/fx_seeded.py", MULTILINE_ISINSTANCE_SRC,
                                     "gate-put-capability", False),
    "undominated put in serve": ("src/repro_torch/serve/fx_seeded.py", CAP_SRC, "capability-dominance", True),
    "undominated put in the comm layer": ("src/repro_torch/core/comm/fx_seeded.py", CAP_SRC,
                                          "capability-dominance", False),
    "pickle on the wire": ("src/repro_torch/serve/fx_seeded.py", "import pickle\n", "gate-no-pickle-wire", True),
    "pickle off the wire": ("src/repro_torch/checkpoint/fx_seeded.py", "import pickle\n",
                            "gate-no-pickle-wire", False),
    "queue in serve": ("src/repro_torch/serve/fx_seeded.py", ALIASED_QUEUE_SRC, "gate-serving-comm", True),
}


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_seeded_violation_at_a_port_path(case):
    """A violation placed at a port path is caught where the reference
    polices that sub-tree and allowed where it allows it."""
    rel, src, pass_id, caught = SEEDED[case]
    found = [f for f in findings_of(_ctx(tregistry, {rel: src}), pass_id) if f.file == rel]
    assert bool(found) == caught, found


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The launcher over the real tree (``--strict``, JSON in a temporary
    directory), and over a copy of the port with one violation seeded at
    ``src/repro_torch/core/fx_seeded.py``."""
    tmp = tmp_path_factory.mktemp("analyze")
    launcher = [sys.executable, str(REPO / "tools" / "torch_analyze.py")]
    green = subprocess.run(launcher + ["--strict", "--json", str(tmp / "findings.json")],
                           capture_output=True, text=True, timeout=300)
    root = tmp / "seeded"
    shutil.copytree(REPO / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src" / "repro_torch" / "core" / "fx_seeded.py").write_text(textwrap.dedent(BLOCKING_SRC))
    red = subprocess.run(launcher + ["--strict", "--root", str(root), "--baseline",
                                     str(REPO / "tools" / "torch_analysis_baseline.json"),
                                     "--json", str(tmp / "seeded.json")],
                         capture_output=True, text=True, timeout=300)
    return green, json.loads((tmp / "findings.json").read_text()), red, json.loads((tmp / "seeded.json").read_text())


def test_analyze_cli_strict_green_and_json(cli_runs):
    green, data, _, _ = cli_runs
    assert green.returncode == 0, green.stdout + green.stderr
    assert "13 pass(es), 0 new finding(s), 8 baselined, 0 stale" in green.stdout
    assert data["new"] == [] and data["stale_baseline"] == []
    assert len(data["baselined"]) == 8
    assert all(f["file"].startswith("src/repro_torch/") for f in data["baselined"])


def test_analyze_cli_fails_on_a_seeded_port_violation(cli_runs):
    _, _, red, data = cli_runs
    assert red.returncode == 1, red.stdout + red.stderr
    assert [f["fingerprint"] for f in data["new"]] == [
        "blocking-under-lock:src/repro_torch/core/fx_seeded.py:Engine.step:sleep:Engine.lk"]
    assert len(data["baselined"]) == 8 and data["stale_baseline"] == []


def test_analyze_cli_unknown_pass_errors():
    out = subprocess.run([sys.executable, str(REPO / "tools" / "torch_analyze.py"), "-p", "no-such-pass"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and "no-such-pass" in out.stderr


def test_analyze_cli_lists_thirteen_passes():
    from repro_torch.analysis.cli import main

    assert main(["--list"]) == 0
    out = subprocess.run([sys.executable, str(REPO / "tools" / "torch_analyze.py"), "--list"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and sorted(ln.split()[0] for ln in out.stdout.splitlines()) == sorted(PASSES)
