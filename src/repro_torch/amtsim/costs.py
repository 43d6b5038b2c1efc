"""Cost models for the parcelport simulation.

All times in **seconds**.  The mechanism constants below were calibrated once
against the paper's Expanse results (§4.2, Figs 3-4): the calibration targets
are the *relative* claims (≈3× short-message rate vs best MPI variant, ≈20×
16KiB rate, ≈50× vs ``mpi_a`` on large messages, ≈4× LCI thread scaling,
≈2× Octo-Tiger at scale) plus sane absolute magnitudes (µs-scale software
overheads, HDR-IB wire rates).  EXPERIMENTS.md records the validation.

Platform constants model the NIC/wire; mechanism constants model the
software stack the paper varies.

**Modeled:** per-operation software costs (posting, matching, completion
objects, locks with per-waiter contention penalties, MPI_Test serialization,
aggregation merge, serialization per byte) and the injection-side costs of
resource exhaustion (``t_post_eagain`` — a refused post under the bounded
fabric of :mod:`repro_torch.amtsim.parcelport_sim`).  **Abstracted away:** cache
geometry, NUMA, and instruction-level behaviour — every such effect is
folded into one calibrated scalar per mechanism.  Changing a constant here
re-calibrates every benchmark claim downstream; EXPERIMENTS.md records the
validation runs that anchor the current values.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

US = 1e-6  # microsecond


@dataclass(frozen=True)
class Platform:
    name: str
    wire_latency: float = 1.2 * US  # one-way, HDR InfiniBand
    # per-device injection: a message occupies the device for
    # max(inj_overhead, bytes / bandwidth)
    inj_overhead: float = 0.22 * US  # ≈4.5 M msg/s per device peak
    bandwidth: float = 12.5e9  # 2x50 Gb/s HDR ≈ 12.5 GB/s
    # Delta/Slingshot-11: libfabric wraps its CQ poll in a pthread spin lock
    # (§4.2.3 — 85% of time on 32 nodes spent in that lock).
    libfabric_cq_lock: bool = False
    progress_lock_cost: float = 0.0  # extra serialized time per progress


EXPANSE = Platform(name="expanse")
FRONTERA = Platform(name="frontera", inj_overhead=0.25 * US)
# Slingshot-11: faster wire on paper, but the shared libfabric CQ lock
# serializes polling (modeled as a mandatory coarse lock around progress).
DELTA = Platform(
    name="delta",
    wire_latency=1.1 * US,
    bandwidth=25.0e9,
    inj_overhead=0.30 * US,
    libfabric_cq_lock=True,
    progress_lock_cost=0.25 * US,
)

PLATFORMS = {"expanse": EXPANSE, "frontera": FRONTERA, "delta": DELTA}


@dataclass(frozen=True)
class Mechanisms:
    """Software costs for each mechanism the paper studies."""

    # posting operations
    t_post_send: float = 0.15 * US
    t_post_recv: float = 0.15 * US
    t_tag_match: float = 0.25 * US  # two-sided receive path (§3.3.1)
    t_put_deliver: float = 0.08 * US  # dynamic put: hand buffer to user
    # put-signal completion (§3.3.1, the middle capability-ladder rung):
    # the receiver discovers a completed put by testing raised per-slot
    # signal flags — cheaper than tag matching, but the scan is a
    # serialized sweep (charged under the match lock), unlike the
    # lock-free queue-completion path above
    t_put_signal: float = 0.05 * US

    # progress engine
    t_progress_poll: float = 0.12 * US  # one CQ poll sweep
    t_per_completion: float = 0.06 * US

    # completion objects (§5.2)
    t_cq_push: dict = field(
        default_factory=lambda: {"lcrq": 0.05 * US, "ms": 0.14 * US, "lock": 0.30 * US}
    )
    t_cq_pop: dict = field(
        default_factory=lambda: {"lcrq": 0.05 * US, "ms": 0.14 * US, "lock": 0.30 * US}
    )
    # contention penalty per concurrent accessor beyond the first
    cq_contention: dict = field(
        default_factory=lambda: {"lcrq": 0.004 * US, "ms": 0.08 * US, "lock": 0.25 * US}
    )
    t_sync_signal: float = 0.02 * US  # synchronizer = single 4B store
    t_sync_test: float = 0.05 * US  # one request test (no match)

    # MPI-specific (§3.3.2, §3.3.4)
    t_mpi_test: float = 0.60 * US  # MPI_Test incl. implicit progress entry
    t_mpi_big_lock: float = 0.10 * US  # serialized section per MPI call

    # bounded injection (§3.3.4): a post refused by a full send ring or an
    # exhausted bounce-buffer pool still costs the failed descriptor write /
    # pool probe before the library parks the post for retry
    t_post_eagain: float = 0.03 * US

    # RNR retry storms (§3.1): with ``SimConfig.rnr_storm`` set, a
    # receiver-not-ready arrival is retransmitted by the NIC after this
    # base backoff, doubling per failed attempt (capped at 64x) — instead
    # of the free redelivery-on-reap of the default model.  Real HDR-IB
    # RNR timers are far larger; this value is scaled to the simulated
    # µs regime so storms visibly collapse throughput without freezing
    # the event loop.
    t_rnr_retry: float = 2.0 * US

    # locks (§5.3).  Beyond FIFO serialization, every blocking acquisition
    # pays a penalty per waiter queued behind the lock — cache-line
    # bouncing / futex wakeups scale with the contender count, which is the
    # paper's "most crucial factor" (thread contention on coarse locks).
    t_lock_uncontended: float = 0.04 * US
    t_lock_contention: float = 0.08 * US
    t_try_fail: float = 0.02 * US

    # upper layer
    t_serialize_per_byte: float = 1.0 / 12e9  # memcpy-bound
    # eager shipment beyond the header-piggyback limit copies the payload
    # into a pre-registered bounce buffer (§3.3.4) — a distinct, separately
    # calibrated memcpy from serialization, so experiments can vary
    # registered-memory bandwidth without touching the serializer (the two
    # coincide on the calibrated platforms, hence the equal default)
    t_bounce_copy_per_byte: float = 1.0 / 12e9
    t_handle_parcel: float = 0.5 * US  # spawn the task, bookkeeping
    t_aggregate: float = 0.3 * US  # parcel queue lock + merge per parcel

    # Elastic membership (the lci_eprg family): control-plane costs of resizing a
    # live worker pool.  Joining spawns/registers a worker (thread start +
    # endpoint re-wire); draining quiesces in-flight work before the slot
    # is released; a state handoff streams the departing worker's shard to
    # its successor at registered-memory copy bandwidth.
    t_worker_join: float = 5.0 * US
    t_worker_drain: float = 3.0 * US
    t_handoff_per_byte: float = 1.0 / 12e9

    def variant(self, **kw) -> "Mechanisms":
        return replace(self, **kw)


DEFAULT_MECHANISMS = Mechanisms()
