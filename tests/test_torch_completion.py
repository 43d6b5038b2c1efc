"""Port parity: the completion mechanisms (paper §3.3.2, §5.2).

``tests/test_completion.py``'s checks on ``repro_torch.core.completion``
— the three MPMC queues (threaded lossless and duplicate-free), the
synchronizer and its pool, the factory — each held against the same
program on the reference's classes; and the sanitizer's hooks: the
port's ``LCRQueue`` reports its traffic to the port's sanitizer on push
and on pop, as the reference's does to its own."""
import collections
import threading

import pytest
from _hypothesis_compat import given, settings, st

from repro.analysis import sanitizer as j_sanitizer
from repro.core import completion as jcompletion
from repro_torch.analysis import sanitizer
from repro_torch.core import completion as tcompletion
from repro_torch.core.completion import (
    LCRQueue,
    LockQueue,
    MichaelScottQueue,
    Synchronizer,
    SynchronizerPool,
    make_completion_queue,
)

QUEUES = ["LCRQueue", "MichaelScottQueue", "LockQueue"]


def _pair(name):
    return getattr(jcompletion, name), getattr(tcompletion, name)


@pytest.mark.parametrize("qname", QUEUES)
def test_fifo_single_thread(qname):
    outs = []
    for qcls in _pair(qname):
        q = qcls()
        for i in range(100):
            q.push(i)
        out = [q.pop() for _ in range(100)]
        assert out == list(range(100))
        assert q.pop() is None
        outs.append(out)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("qname", QUEUES)
def test_interleaved(qname):
    outs = []
    for qcls in _pair(qname):
        q = qcls()
        q.push("a")
        trace = [q.pop(), q.pop()]
        q.push("b")
        q.push("c")
        trace.append(q.pop())
        assert trace == ["a", None, "b"]
        outs.append((trace, len(q), q.cost_model_name))
    assert outs[0] == outs[1]


def test_lcrq_segment_overflow():
    for qcls in _pair("LCRQueue"):
        q = qcls(segment_size=8)
        n = 100
        for i in range(n):
            q.push(i)
        assert [q.pop() for _ in range(n)] == list(range(n))


@pytest.mark.parametrize("qname", QUEUES)
def test_mpmc_lossless_duplicate_free(qname):
    """Threaded torture: every pushed item popped exactly once (the pop
    order depends on the scheduler, the multiset does not)."""
    _, qcls = _pair(qname)
    q = qcls()
    n_prod, n_cons, per = 4, 4, 500
    popped = []
    popped_lock = threading.Lock()
    done = threading.Event()

    def producer(pid):
        for i in range(per):
            q.push((pid, i))

    def consumer():
        local = []
        while not done.is_set() or len(q) > 0:
            item = q.pop()
            if item is not None:
                local.append(item)
        with popped_lock:
            popped.extend(local)

    cons = [threading.Thread(target=consumer) for _ in range(n_cons)]
    prods = [threading.Thread(target=producer, args=(p,)) for p in range(n_prod)]
    for t in cons + prods:
        t.start()
    for t in prods:
        t.join()
    done.set()
    for t in cons:
        t.join()
    while True:  # drain stragglers
        item = q.pop()
        if item is None:
            break
        popped.append(item)
    assert sorted(popped) == sorted((p, i) for p in range(n_prod) for i in range(per))


def test_synchronizer_single_slot():
    outs = []
    for cls in _pair("Synchronizer"):
        s = cls()
        trace = [s.test()]
        s.signal("x")
        trace += [s.ready, s.test(), s.test()]  # consumed
        assert trace == [None, True, "x", None]
        outs.append(trace)
    assert outs[0] == outs[1]


def test_synchronizer_pool_round_robin():
    outs = []
    for mod in (jcompletion, tcompletion):
        pool = mod.SynchronizerPool()
        syncs = [mod.Synchronizer() for _ in range(3)]
        for i, s in enumerate(syncs):
            pool.add(s, payload=i)
        syncs[2].signal("done")
        results = [pool.poll_one() for _ in range(6)]
        assert [r for r in results if r is not None] == [(2, "done")]
        assert len(pool) == 2  # completed one removed
        outs.append(results)
    assert outs[0] == outs[1]


def test_factory():
    for kind in ("lcrq", "ms", "lock"):
        q, jq = make_completion_queue(kind), jcompletion.make_completion_queue(kind)
        assert q.cost_model_name == jq.cost_model_name == kind
        assert type(q).__name__ == type(jq).__name__
    for mod in (jcompletion, tcompletion):
        with pytest.raises(ValueError):
            mod.make_completion_queue("bogus")


@pytest.mark.parametrize("qname", QUEUES + ["Synchronizer"])
def test_completion_target_surface_matches(qname):
    """signal()/reap() and drain() — the CompletionTarget surface a
    backend hands completions through — behave as the reference's."""
    outs = []
    for cls in _pair(qname):
        q = cls()
        trace = []
        for i in range(3):
            q.signal(i)
            trace.append(q.reap())
        trace.append(q.reap())
        if hasattr(q, "drain"):
            for i in range(20):
                q.push(i)
            trace.append(q.drain(max_n=16))
            trace.append(q.drain())
        outs.append(trace)
    assert outs[0] == outs[1]


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(), min_size=0, max_size=200))
def test_lcrq_sequential_equiv_property(items):
    """LCRQ behaves as a FIFO queue under any sequential program, as the
    reference's does."""
    q, jq = LCRQueue(segment_size=16), jcompletion.LCRQueue(segment_size=16)
    ref = collections.deque()
    for it in items:
        q.push((it,))
        jq.push((it,))
        ref.append((it,))
    while ref:
        want = ref.popleft()
        assert q.pop() == want == jq.pop()
    assert q.pop() is None and jq.pop() is None


@pytest.fixture
def sanitize():
    was = sanitizer.enabled()
    sanitizer.reset()
    sanitizer.enable(True)
    yield
    sanitizer.enable(was)
    sanitizer.reset()


def test_lcrq_reports_push_and_pop_to_the_port_sanitizer(sanitize):
    """The note_exercise hooks at the reference's two places: one count a
    push and one a pop (an empty pop too), per queue; the other queues
    carry no hook, as in the reference."""
    q = LCRQueue()
    for i in range(5):
        q.push(i)
    for _ in range(7):  # 5 items, then two empty pops
        q.pop()
    MichaelScottQueue().push(1)
    LockQueue().push(1)
    Synchronizer().signal(1)
    SynchronizerPool().add(Synchronizer(), payload=0)
    report = sanitizer.session_report()
    assert report["exercised"] == {"LCRQueue": 12}
    assert report["races"] == []
    # the reference counts the same program the same way
    j_was = j_sanitizer.enabled()
    j_sanitizer.reset()
    j_sanitizer.enable(True)
    try:
        jq = jcompletion.LCRQueue()
        for i in range(5):
            jq.push(i)
        for _ in range(7):
            jq.pop()
        assert j_sanitizer.session_report()["exercised"] == report["exercised"]
    finally:
        j_sanitizer.enable(j_was)
        j_sanitizer.reset()


def test_lcrq_is_silent_when_the_sanitizer_is_off():
    was = sanitizer.enabled()
    sanitizer.reset()
    sanitizer.enable(False)
    try:
        q = LCRQueue()
        q.push(1)
        q.pop()
        assert sanitizer.exercised_structures() == {}
    finally:
        sanitizer.enable(was)
        sanitizer.reset()
