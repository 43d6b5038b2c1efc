"""Property-based channel and fleet suite, on the port.

``tests/test_channel_properties.py``'s three properties against the
port's :class:`~repro_torch.core.comm.collective.CommChannel` and
:class:`~repro_torch.serve.Fleet` (smoke configs, CPU).  Hypothesis
drives random interleavings of submits, EAGAIN refusals, progress steps
and reaps against every backend (collective, shmem, shmem with signal
completion), bounded and not:

* **FIFO non-overtaking** — at every reap point, the payloads received in
  each direction are a prefix of the payloads submitted in that direction;
* **deliver-exactly-once** — after quiescing, every submitted payload was
  delivered exactly once, in order.

Each schedule also runs on the reference's channel: the same deliveries
and the same count of backpressure parks.  Then the burst-then-drain
regression, and the fleet property: for any request trace, worker count
and chunking, the port's fleet emits the port's single host's streams."""
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core.comm.collective import CommChannel as JCommChannel
from repro.core.comm.resources import ResourceLimits as JResourceLimits
from repro.core.comm.shmem import ShmemGroup as JShmemGroup
from repro_torch.core.comm.collective import CommChannel
from repro_torch.core.comm.resources import ResourceLimits
from repro_torch.core.comm.shmem import ShmemGroup

torch.set_num_threads(1)

# op codes for the schedule strategy: plain ints keep shrinking effective
OP_SUBMIT_REQ = 0
OP_SUBMIT_RESP = 1
OP_PROGRESS_CLIENT = 2
OP_PROGRESS_SERVER = 3
OP_DRAIN = 4
OP_REAP_REQ = 5
OP_REAP_RESP = 6
_OP_NAMES = ["submit_req", "submit_resp", "progress_c", "progress_s", "drain", "reap_req", "reap_resp"]

TIGHT = dict(send_queue_depth=1, bounce_buffers=1, bounce_buffer_size=4_096)
BACKENDS = ["collective", "shmem", "shmem_signal"]
BOUNDS = ["tight", "unbounded"]


def _make_channel(backend: str, bound: str, ref: bool = False):
    limits_cls, group_cls, channel_cls = ((JResourceLimits, JShmemGroup, JCommChannel) if ref
                                          else (ResourceLimits, ShmemGroup, CommChannel))
    limits = limits_cls(**TIGHT) if bound == "tight" else limits_cls()
    if backend == "shmem_signal":
        # the put-signal completion rung: raised flags discovered by scan
        group = group_cls(2, 1, limits=limits, completion_mode="signal")
        return channel_cls(limits=limits, backend="shmem", group=group)
    return channel_cls(limits=limits, backend=backend)


class _Driver:
    """Applies an op schedule to a channel, recording delivery order."""

    def __init__(self, channel, schedule):
        self.ch = channel
        self.schedule = schedule
        self.sent_req, self.sent_resp = [], []  # payloads submitted, in order
        self.got_req, self.got_resp = [], []  # payloads reaped, in order

    def _fail(self, why: str):  # the shrunk schedule, printable
        pytest.fail(f"{why}\nop schedule: {[_OP_NAMES[op] for op in self.schedule]}")

    def _check_prefix(self):
        # FIFO non-overtaking, checked at EVERY reap point
        if self.got_req != self.sent_req[: len(self.got_req)]:
            self._fail(f"requests overtook: got {self.got_req} of {self.sent_req}")
        if self.got_resp != self.sent_resp[: len(self.got_resp)]:
            self._fail(f"responses overtook: got {self.got_resp} of {self.sent_resp}")

    def _reap_one(self, source: str) -> bool:
        rec = self.ch.reap(source)
        if rec is None:
            return False
        if rec.op != "send":  # arrivals only; send completions carry no payload
            self.ch.repost(rec.ctx)
            (self.got_req if source == "request" else self.got_resp).append(bytes(rec.data))
            self._check_prefix()
        return True

    def run(self):
        for n, op in enumerate(self.schedule):
            if op == OP_SUBMIT_REQ:
                payload = b"q%d" % n
                self.sent_req.append(payload)
                self.ch.send_request(payload)  # EAGAIN parks inside
            elif op == OP_SUBMIT_RESP:
                payload = b"r%d" % n
                self.sent_resp.append(payload)
                self.ch.send_response(payload)
            elif op == OP_PROGRESS_CLIENT:
                self.ch.client.progress()
            elif op == OP_PROGRESS_SERVER:
                self.ch.server.progress()
            elif op == OP_DRAIN:
                self.ch.drain_retries()
            elif op == OP_REAP_REQ:
                self._reap_one("request")
            elif op == OP_REAP_RESP:
                self._reap_one("response")
        # quiesce: whatever the schedule left parked or in flight must drain
        for _ in range(500):
            moved = self.ch.drain_retries()
            moved = self.ch.progress() or moved
            while self._reap_one("request"):
                moved = True
            while self._reap_one("response"):
                moved = True
            if not moved and not self.ch.pending_work():
                break
        else:
            self._fail(f"channel failed to quiesce (pending_work={self.ch.pending_work()}, "
                       f"parks={self.ch.backpressure_parks()})")
        # deliver-exactly-once: everything submitted arrived, in order
        if self.got_req != self.sent_req:
            self._fail(f"request delivery mismatch: {self.got_req} != {self.sent_req}")
        if self.got_resp != self.sent_resp:
            self._fail(f"response delivery mismatch: {self.got_resp} != {self.sent_resp}")
        return self.got_req, self.got_resp, self.ch.backpressure_parks()


def _run_both(backend, bound, schedule):
    port = _Driver(_make_channel(backend, bound), schedule).run()
    ref = _Driver(_make_channel(backend, bound, ref=True), schedule).run()
    assert port == ref, f"port {port} != reference {ref} on {[_OP_NAMES[op] for op in schedule]}"
    return port


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("bound", BOUNDS)
@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=6), min_size=0, max_size=60))
def test_channel_fifo_and_exactly_once(backend, bound, schedule):
    """Random interleavings of submits, progress, EAGAIN parks and reaps
    preserve per-direction FIFO and deliver-exactly-once on every backend,
    bounded or not, and deliver as the reference's channel does."""
    _run_both(backend, bound, schedule)


@pytest.mark.parametrize("backend", BACKENDS)
def test_channel_regression_burst_then_drain(backend):
    """The worst shrunk shape, pinned: a burst in both directions with NO
    interleaved progress (everything parks or queues), then the
    quiescence loop alone delivers."""
    got_req, got_resp, parks = _run_both(backend, "tight", [OP_SUBMIT_REQ] * 8 + [OP_SUBMIT_RESP] * 8)
    assert len(got_req) == len(got_resp) == 8
    assert parks > 0  # the tight limits did refuse posts


# --------------------------------------------------------------------- fleet
@pytest.fixture(scope="module")
def smoke_model():
    from repro_torch.configs import SMOKES
    from repro_torch.models import init_params

    arch = SMOKES["tinyllama-1.1b"].variant(dtype="float32")
    return arch, init_params(torch.Generator().manual_seed(0), arch)


@settings(max_examples=6, deadline=None)
@given(
    st.lists(
        st.tuples(
            st.lists(st.integers(min_value=1, max_value=50), min_size=1, max_size=6),
            st.integers(min_value=1, max_value=4),
        ),
        min_size=1,
        max_size=4,
    ),
    st.integers(min_value=1, max_value=3),
    st.integers(min_value=0, max_value=2),
)
def test_fleet_matches_single_host_on_random_traces(smoke_model, trace, workers, chunk):
    """For ANY request trace, worker count and chunking choice, the port's
    fleet emits exactly the per-request token streams of the port's single
    host with the same chunking — sharding and routing move bytes, not
    math."""
    from repro_torch.serve import Fleet, FleetConfig, InferenceServer, ServeConfig

    arch, params = smoke_model
    slots = max(2, workers)
    single = InferenceServer(arch, params, ServeConfig(slots=slots, context=64, transport="inline",
                                                       prefill_chunk=chunk))
    fleet = Fleet(arch, params, FleetConfig(workers=workers, slots=slots, context=64, transport="inline",
                                            prefill_chunk=chunk))
    try:
        ref = [single.submit(p, max_new=m) for p, m in trace]
        single.run_until_idle()
        out = [fleet.submit(p, max_new=m) for p, m in trace]
        fleet.run_until_idle()
        assert all(r.done_event.is_set() for r in ref)
        assert all(r.done_event.is_set() for r in out), (
            f"fleet dropped requests on trace={trace} workers={workers} chunk={chunk}")
        assert [r.out_tokens for r in out] == [r.out_tokens for r in ref], (
            f"token streams diverged on trace={trace} workers={workers} chunk={chunk}")
    finally:
        fleet.close()
