"""The port's lockset sanitizer over the parcelport stack.

The port's counterpart of ``tests/conftest.py``'s session check, which
reads only the reference's sanitizer: with ``repro_torch.analysis.
sanitizer`` on, ``deliver_payloads`` drives ``lci``, ``collective`` and
``shmem_putq`` (and ``lci_prg2``, whose dedicated progress threads race
the main thread for real); the port's ``session_report()`` must show the
``LCRQueue`` and the fabric's locked structures exercised, and no race.
On the single-threaded variants the counts equal the reference
sanitizer's on the same run."""
import pytest

from repro.analysis import sanitizer as j_sanitizer
from repro.core import harness as jharness
from repro_torch.analysis import sanitizer
from repro_torch.core import harness as tharness

PAYLOADS = [bytes([s % 251]) * s for s in (8, 600, 3_000, 12_000, 40_000)]
FABRIC = {"NetDevice._posted_recvs", "NetDevice.send_ring", "NetDevice._cq"}
SHMEM = {"ShmemSegment.slots", "ShmemSegment.rxq", "ShmemComm.send_ring"}
EXPECT = {"lci": {"LCRQueue"} | FABRIC, "collective": {"LCRQueue"}, "shmem_putq": {"LCRQueue"} | SHMEM,
          "lci_prg2": {"LCRQueue"} | FABRIC}


def _session(mod, harness, variant):
    """Run one delivery under ``mod`` (a sanitizer module) switched on,
    from a clean slate; return its session report."""
    was = mod.enabled()
    mod.reset()
    mod.enable(True)
    try:
        world, got = harness.deliver_payloads(variant, PAYLOADS, max_rounds=50_000)
        try:
            assert sorted(bytes(a[0]) for a in got) == sorted(PAYLOADS)
        finally:
            world.close()
        return mod.session_report()
    finally:
        mod.enable(was)
        mod.reset()


@pytest.mark.parametrize("variant", sorted(EXPECT))
def test_parcelport_traffic_runs_clean_under_the_port_sanitizer(variant):
    report = _session(sanitizer, tharness, variant)
    assert report["enabled"]
    assert EXPECT[variant] <= set(report["exercised"]), report["exercised"]
    assert report["races"] == []
    if variant != "lci_prg2":  # single-threaded: the same operations, counted the same
        assert report["exercised"] == _session(j_sanitizer, jharness, variant)["exercised"]


def test_the_port_stack_reports_to_the_port_sanitizer_only():
    """The port's structures count in the port's sanitizer and never in
    the reference's (and the reverse): the two packages share no state."""
    j_was = j_sanitizer.enabled()
    j_sanitizer.reset()
    j_sanitizer.enable(True)
    try:
        report = _session(sanitizer, tharness, "lci")
        assert report["exercised"] and j_sanitizer.exercised_structures() == {}
    finally:
        j_sanitizer.enable(j_was)
        j_sanitizer.reset()
