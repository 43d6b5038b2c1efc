"""Port parity: the native layer (fabric) and the LCI device.

``tests/test_fabric_device.py``'s checks — RNR and retry, the one-sided
put, tag matching with any-source, the unexpected-message queue, try-lock
progress contention, multi-device isolation — run on the port's
``repro_torch.core.fabric`` / ``device`` / ``completion``, and each is held
against the same program on the reference's modules: the same
completions, the same bytes, the same ``FabricStats``."""
import dataclasses
import importlib

import pytest

PKGS = ("repro", "repro_torch")


def _core(pkg):
    return {n: importlib.import_module(f"{pkg}.core.{n}") for n in ("completion", "device", "fabric")}


def _both(program):
    """Run ``program(modules)`` on the reference's modules and the port's;
    return (reference result, port result)."""
    return tuple(program(_core(pkg)) for pkg in PKGS)


def mk_pair(m, devices_per_rank=1, lock_mode="none"):  # LockMode's values are these strings
    fab = m["fabric"].Fabric(2, devices_per_rank=devices_per_rank)
    cq0, cq1 = m["completion"].LCRQueue(), m["completion"].LCRQueue()
    d0 = m["device"].LCIDevice(fab.device(0, 0), lock_mode=lock_mode, put_target_comp=cq0)
    d1 = m["device"].LCIDevice(fab.device(1, 0), lock_mode=lock_mode, put_target_comp=cq1)
    return fab, d0, d1, cq0, cq1


def drain(*devs, rounds=50):
    for _ in range(rounds):
        moved = False
        for d in devs:
            if d.progress():
                moved = True
        if not moved:
            return


def _rec(rec):
    return None if rec is None else (rec.op, rec.tag, rec.src_rank, bytes(rec.data) if rec.data is not None else None)


def _stats(fab):
    return dataclasses.asdict(fab.stats)


def test_rnr_retry_semantics():
    """Two-sided send with no remote posted receive RNRs, then retries."""

    def program(m):
        fab = m["fabric"].Fabric(2, devices_per_rank=1, recv_slots=0)
        nd0, nd1 = fab.device(0), fab.device(1)
        nd0.post_send(1, 0, b"hello")
        assert fab.stats.rnr_events == 1
        assert nd1.cq_depth() == 0
        nd1.post_recv()
        assert nd0.hw_progress()  # retry succeeds now
        comps = nd1.poll_cq()
        assert len(comps) == 1 and comps[0].data == b"hello"
        return [(c.kind, c.src_rank, bytes(c.data)) for c in comps], _stats(fab)

    ref, port = _both(program)
    assert port == ref


def test_put_dynamic_no_receive_needed():
    def program(m):
        fab, d0, d1, cq0, cq1 = mk_pair(m)
        sent = m["completion"].Synchronizer()
        d0.put_dynamic(1, 0, b"payload", sent)
        drain(d0, d1)
        rec = cq1.pop()
        assert rec is not None and rec.op == "put_recv" and rec.data == b"payload"
        assert sent.test() is not None  # local send completion
        return _rec(rec), _stats(fab)

    ref, port = _both(program)
    assert port == ref


def test_tag_matching_and_any_source():
    def program(m):
        fab, d0, d1, cq0, cq1 = mk_pair(m)
        got = m["completion"].LCRQueue()
        d1.post_recv(src_rank=0, tag=7, comp=got)
        d0.post_send(1, 0, tag=7, data=b"tagged", comp=m["completion"].Synchronizer())
        drain(d0, d1)
        rec = got.pop()
        assert rec.op == "recv" and rec.tag == 7 and rec.data == b"tagged"
        got2 = m["completion"].LCRQueue()  # any-source
        d1.post_recv(src_rank=-1, tag=9, comp=got2)
        d0.post_send(1, 0, tag=9, data=b"any", comp=m["completion"].Synchronizer())
        drain(d0, d1)
        rec2 = got2.pop()
        assert rec2.data == b"any"
        return _rec(rec), _rec(rec2), _stats(fab)

    ref, port = _both(program)
    assert port == ref


def test_unexpected_message_queue():
    """Send arrives before the receive is posted: matched on post."""

    def program(m):
        fab, d0, d1, cq0, cq1 = mk_pair(m)
        d0.post_send(1, 0, tag=3, data=b"early", comp=m["completion"].Synchronizer())
        drain(d0, d1)
        got = m["completion"].LCRQueue()
        d1.post_recv(src_rank=0, tag=3, comp=got)
        rec = got.pop()
        assert rec is not None and rec.data == b"early"
        return _rec(rec), _stats(fab)

    ref, port = _both(program)
    assert port == ref


def test_try_lock_progress_contention():
    def program(m):
        fab, d0, d1, cq0, cq1 = mk_pair(m, lock_mode="try")
        d0._coarse.acquire()  # simulate a holder
        assert d0.progress() is False  # try-lock gives up
        failures = d0.lock_failures
        assert failures >= 1
        d0._coarse.release()
        d0.progress()  # now fine
        return failures, d0.lock_failures

    ref, port = _both(program)
    assert port == ref


def test_multi_device_isolation():
    def program(m):
        fab = m["fabric"].Fabric(2, devices_per_rank=2)
        cq = m["completion"].LCRQueue()
        LCIDevice = m["device"].LCIDevice
        send_dev = LCIDevice(fab.device(0, 1), put_target_comp=None)
        recv_dev = LCIDevice(fab.device(1, 1), put_target_comp=cq)
        other = LCIDevice(fab.device(1, 0), put_target_comp=m["completion"].LCRQueue())
        send_dev.put_dynamic(1, 1, b"dev1", m["completion"].Synchronizer())
        drain(send_dev, recv_dev, other)
        rec = cq.pop()
        assert rec.data == b"dev1"
        assert other.put_target_comp.pop() is None  # landed on the right device
        return _rec(rec), _stats(fab)

    ref, port = _both(program)
    assert port == ref


@pytest.mark.parametrize("lock_mode", ["none", "block", "try"])
def test_device_wire_and_capabilities_match_the_reference(lock_mode):
    """The device's constants, capabilities and the bytes it puts on the
    fabric for a mixed run of two-sided sends and puts."""

    def program(m):
        assert m["device"].WIRE_OVERHEAD == 8
        fab, d0, d1, cq0, cq1 = mk_pair(m, lock_mode=lock_mode)
        caps = dataclasses.asdict(d0.capabilities)
        got = m["completion"].LCRQueue()
        for i in range(6):
            d1.post_recv(src_rank=0, tag=i, comp=got)
        for i in range(6):
            d0.post_send(1, 0, tag=i, data=bytes([i]) * (17 * i + 1), comp=m["completion"].Synchronizer())
            d0.put_dynamic(1, 0, bytes([100 + i]) * (5 * i + 3), m["completion"].Synchronizer())
        drain(d0, d1)
        recs = [_rec(r) for r in iter(got.pop, None)] + [_rec(r) for r in iter(cq1.pop, None)]
        return m["device"].WIRE_OVERHEAD, caps, recs, _stats(fab)

    ref, port = _both(program)
    assert port == ref
    assert len(port[2]) == 12


def test_registered_buffer_pool_and_bounded_send_queue_match():
    def program(m):
        pool = m["fabric"].RegisteredBufferPool(2, 1024)
        a, b = pool.acquire(100), pool.acquire(1024)
        trace = [a is not None, b is not None, pool.acquire(1) is None, pool.acquire(2048) is None]
        pool.release(a)
        trace += [pool.free_count(), pool.acquire(512) is not None]
        fab = m["fabric"].Fabric(2, devices_per_rank=1, recv_slots=8, send_queue_depth=1)
        nd = fab.device(0)
        trace += [bool(nd.post_send(1, 0, b"one")), bool(nd.post_send(1, 0, b"two"))]
        nd.poll_cq()
        trace += [nd.inflight_sends(), bool(nd.post_send(1, 0, b"two"))]
        return trace, _stats(fab)

    ref, port = _both(program)
    assert port == ref
    assert port[0] == [True, True, True, True, 1, True, True, False, 0, True]
