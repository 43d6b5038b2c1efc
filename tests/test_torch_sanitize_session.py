"""The port's session check under ``REPRO_SANITIZE=1``.

``tests/conftest.py``'s session check reads only the reference's
sanitizer.  This is the port's: a fresh interpreter with
``REPRO_SANITIZE=1`` in its environment from the start (the sanitizer
reads it at import, so every lock the port builds is a ``SanLock``)
drives the port's ``lci``, ``lci_prg2``, ``collective`` and
``shmem_putq`` through ``harness.deliver_payloads``, and a ``Membership``
whose members join and leave from the main thread and from a worker of
the nursery.  ``repro_torch.analysis.sanitizer.session_report()`` must
then show the port's structures exercised and no race.  The child imports
nothing of the JAX package."""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = r"""
import json
import sys

from repro_torch.analysis import sanitizer
from repro_torch.core import harness
from repro_torch.core.comm.membership import Membership, join_workers, spawn_worker

assert sanitizer.enabled()
payloads = [bytes([s % 251]) * s for s in (8, 600, 3_000, 12_000, 40_000)]
delivered = {}
for name in ("lci", "lci_prg2", "collective", "shmem_putq"):
    world, got = harness.deliver_payloads(name, payloads, max_rounds=50_000)
    try:
        delivered[name] = sorted(bytes(a[0]) for a in got) == sorted(payloads)
    finally:
        world.close()

membership = Membership()


def join_and_leave(rank):
    membership.join(rank)
    membership.activate(rank)
    membership.begin_drain(rank)
    membership.finish_leave(rank)


membership.join(0)
membership.activate(0)
join_workers([spawn_worker(join_and_leave, name="sanitize-member", args=(1,))])
membership.begin_drain(0)
membership.finish_leave(0)
states = [[r, membership.state(r)] for r in (0, 1)]
print(json.dumps({"delivered": delivered, "states": states, "report": sanitizer.session_report(),
                  "jax": any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)}))
"""


def test_port_session_under_repro_sanitize():
    env = dict(os.environ, REPRO_SANITIZE="1", PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["delivered"] == {"lci": True, "lci_prg2": True, "collective": True, "shmem_putq": True}
    assert res["states"] == [[0, "gone"], [1, "gone"]]
    report = res["report"]
    assert report["enabled"]
    assert report["exercised"], "REPRO_SANITIZE=1 but no instrumented structure of the port was exercised"
    assert {"LCRQueue", "NetDevice._cq", "ShmemSegment.slots", "Membership._members"} <= set(report["exercised"])
    assert report["races"] == [], report["races"]
    assert not res["jax"]
