"""Named parcelport variants — the paper's configurations (Figs 6-9) as a
composable registry.

Fixed names cover the factor-study matrix; **parameterized families**
(:class:`~repro_torch.core.comm.registry.VariantSpec`) cover every axis that
sweeps a number, resolved on demand without pre-registration:

* ``lci_d{n}`` / ``lci_try_d{n}`` — device replication (paper Fig 9);
* ``lci_eager_{k}k`` — eager/rendezvous threshold at ``k`` KiB (§3.3/§4.2);
* ``lci_b{depth}`` — **bounded injection** (§3.3.4): send ring and bounce
  pool both ``depth`` deep, via the shared
  :class:`~repro_torch.core.comm.resources.ResourceLimits` — the same object the
  fabric sizes its rings from and the DES simulates, so
  ``make_parcelport_factory("lci_b8")`` and ``sim_config_for_variant
  ("lci_b8")`` can never disagree about what "8" bounds.

``VARIANTS`` remains a dict-compatible view for legacy call sites; every
pre-existing name resolves to a config equal to its old hard-coded value
(regression-tested in tests/test_comm_interface.py).
"""
from __future__ import annotations

from typing import Callable

from .comm.registry import RegistryView, VariantRegistry, VariantSpec
from .comm.resources import ResourceLimits
from .device import LockMode
from .fabric import Fabric
from .lci_parcelport import LCIPPConfig, LCIParcelport
from .mpi_parcelport import MPIParcelport
from .parcelport import Locality, Parcelport

__all__ = [
    "REGISTRY",
    "SERVE_REGISTRY",
    "SERVE_VARIANTS",
    "make_parcelport_factory",
    "make_fleet_config",
    "variant_names",
    "fleet_variant_names",
    "variant_limits",
    "max_devices",
]

REGISTRY = VariantRegistry()

# Default bounce-buffer size for the bounded-injection family: matches the
# fabric's default registered-buffer size, comfortably above the 16 KiB
# eager threshold.
_B_FAMILY_BUF_SIZE = 64 * 1024

# -- fixed variants (the paper's evaluated configurations) -------------------
_FIXED = {
    # §4: the full-fledged LCI parcelport ("base" in §5 factor studies).
    "lci": lambda: LCIPPConfig(name="lci"),
    "base": lambda: LCIPPConfig(name="base"),
    # §5.1 asynchrony: two-sided header transfer keeps the completion queue…
    "sendrecv_queue": lambda: LCIPPConfig(name="sendrecv_queue", header_mode="sendrecv", header_comp="queue"),
    # …or drops to a single synchronizer (one pre-posted receive at a time).
    "sendrecv_sync": lambda: LCIPPConfig(name="sendrecv_sync", header_mode="sendrecv", header_comp="sync"),
    # §5.2 concurrency: synchronizer pool instead of completion queue for
    # everything except header dynamic puts.
    "sync": lambda: LCIPPConfig(name="sync", followup_comp="sync"),
    "queue_lock": lambda: LCIPPConfig(name="queue_lock", cq_kind="lock"),
    "queue_ms": lambda: LCIPPConfig(name="queue_ms", cq_kind="ms"),
    # §5.3 multithreading/progress: MPI-mimicking ladder.  All use
    # send/recv + synchronizers (completion queues don't work under coarse
    # locks, per the paper).
    "block": lambda: LCIPPConfig(
        name="block",
        header_mode="sendrecv",
        header_comp="sync",
        followup_comp="sync",
        ndevices=1,
        lock_mode=LockMode.BLOCK,
        progress_mode="implicit",
    ),
    "try": lambda: LCIPPConfig(
        name="try",
        header_mode="sendrecv",
        header_comp="sync",
        followup_comp="sync",
        ndevices=1,
        lock_mode=LockMode.TRY,
        progress_mode="implicit",
    ),
    "try_progress": lambda: LCIPPConfig(
        name="try_progress",
        header_mode="sendrecv",
        header_comp="sync",
        followup_comp="sync",
        ndevices=1,
        lock_mode=LockMode.TRY,
        progress_mode="explicit",
    ),
    # the catastrophic combination (§5.3): blocking lock + eager progress
    "progress": lambda: LCIPPConfig(
        name="progress",
        header_mode="sendrecv",
        header_comp="sync",
        followup_comp="sync",
        ndevices=1,
        lock_mode=LockMode.BLOCK,
        progress_mode="explicit",
    ),
    "block_d2": lambda: LCIPPConfig(
        name="block_d2",
        header_mode="sendrecv",
        header_comp="sync",
        followup_comp="sync",
        ndevices=2,
        lock_mode=LockMode.BLOCK,
        progress_mode="implicit",
    ),
    # Protocol factor study (§3.3/§4.2): force every parcel down the
    # rendezvous path / alias the calibrated 16 KiB eager default.
    "lci_noeager": lambda: LCIPPConfig(name="lci_noeager", eager_threshold=0),
    "lci_eager": lambda: LCIPPConfig(name="lci_eager", eager_threshold=16 * 1024),
    # Threshold-aware aggregation (§2.2.2 x §3.3): merge same-destination
    # parcels, but pack each aggregate only up to the eager threshold so it
    # still ships as ONE eager message (fills one bounce buffer; never
    # spills an eager-sized batch onto the rendezvous path).
    "lci_agg_eager": lambda: LCIPPConfig(
        name="lci_agg_eager", aggregation=True, agg_eager=True, eager_threshold=16 * 1024
    ),
    # Completion-routing topology (§3.3.3): ONE completion queue shared
    # across devices — LCI's load-balancing default, named so the
    # CompletionRouter axis is sweepable against per-device queues
    # (`.variant(cq_scope='device')`).
    "lci_shared_cq": lambda: LCIPPConfig(name="lci_shared_cq", cq_scope="shared"),
    # The collectives backend (the serving stack's transport): same
    # parcelport protocol logic, CollectiveComm endpoints instead of LCI
    # devices.  No one-sided put, so headers ride two-sided send/recv BY
    # CAPABILITY — the config states the honest path up front.
    "collective": lambda: LCIPPConfig(name="collective", header_mode="sendrecv", header_comp="queue"),
    # The shared-memory backend: the one transport with a TRUE
    # one-sided put, run at every rung of the paper's capability ladder
    # (§3.3.1).  The three rungs reuse the shared header_mode/header_comp
    # axes, so the DES resolves them with no new config fields:
    #   shmem      — two-sided emulation over the same receiver-owned slots;
    #   shmem_put  — put-signal: raised per-slot flags, discovered by a
    #                serialized scan (header_comp='sync');
    #   shmem_putq — put + queue-completion: descriptors enqueued straight
    #                into the receiver's completion ring (the paper's
    #                preferred primitive).
    "shmem": lambda: LCIPPConfig(name="shmem", header_mode="sendrecv", header_comp="queue"),
    "shmem_put": lambda: LCIPPConfig(name="shmem_put", header_mode="put", header_comp="sync"),
    "shmem_putq": lambda: LCIPPConfig(name="shmem_putq", header_mode="put", header_comp="queue"),
}
for _name, _build in _FIXED.items():
    REGISTRY.register(_name, _build)

# -- parameterized families --------------------------------------------------
# device-scaling families (paper Fig 9)
REGISTRY.register_family(VariantSpec(
    grammar="lci_d{n}",
    build=lambda name, n: LCIPPConfig(name=name, ndevices=n),
    canonical=((1,), (2,), (4,), (8,), (16,), (32,)),
    doc="device-replication scaling (lock-free)",
))
REGISTRY.register_family(VariantSpec(
    grammar="lci_try_d{n}",
    build=lambda name, n: LCIPPConfig(name=name, ndevices=n, lock_mode=LockMode.TRY),
    canonical=((1,), (2,), (4,), (8,), (16,), (32,)),
    doc="device scaling under a coarse try lock",
))
# eager-threshold family (§3.3/§4.2: the one-message limit in KiB)
REGISTRY.register_family(VariantSpec(
    grammar="lci_eager_{k}k",
    build=lambda name, k: LCIPPConfig(name=name, eager_threshold=k * 1024),
    canonical=((16,), (64,)),
    doc="eager protocol up to {k} KiB",
))
# progress-policy family (§3.3.4, the paper's omitted experiment): n cores
# reserved to ONLY drive the progress engine (ROLE_PROGRESS threads in the
# functional layer, reserved DES workers in the simulator).  n=0 is the
# all-workers-poll baseline (explicit progress on every worker, plain lci);
# n>0 task workers drop to implicit polling — the dedicated workers own the
# eager progress, matching how such runtimes are actually deployed.
REGISTRY.register_family(VariantSpec(
    grammar="lci_prg{n}",
    build=lambda name, n: LCIPPConfig(
        name=name,
        progress_workers=n,
        progress_mode="explicit" if n == 0 else "implicit",
    ),
    canonical=((0,), (2,)),
    doc="dedicated progress workers: {n} reserved cores drive the engine (0 = all workers poll)",
))
# collective-backend progress family: the collectives transport under
# n dedicated progress workers — the serving stack's progress-policy axis,
# mirroring lci_prg{n} over the other backend.
REGISTRY.register_family(VariantSpec(
    grammar="collective_prg{n}",
    build=lambda name, n: LCIPPConfig(
        name=name,
        header_mode="sendrecv",
        header_comp="queue",
        progress_workers=n,
        progress_mode="explicit" if n == 0 else "implicit",
    ),
    canonical=((2,),),
    doc="collective backend with {n} dedicated progress workers",
))
# shmem-backend progress family: put + queue-completion (the top ladder
# rung) under n dedicated progress workers — the shared-memory transport's
# progress-policy axis, mirroring lci_prg{n}/collective_prg{n}.
REGISTRY.register_family(VariantSpec(
    grammar="shmem_prg{n}",
    build=lambda name, n: LCIPPConfig(
        name=name,
        header_mode="put",
        header_comp="queue",
        progress_workers=n,
        progress_mode="explicit" if n == 0 else "implicit",
    ),
    canonical=((2,),),
    doc="shared-memory put+queue backend with {n} dedicated progress workers",
))
# elastic-progress family: the dedicated pool starts at lo and
# an ElasticProgressController grows/shrinks it between (lo, hi) from the
# engine's reap statistics — the adaptive answer to the §5.3 finding that
# the right lci_prg{n} is workload-dependent.
REGISTRY.register_family(VariantSpec(
    grammar="lci_eprg{lo}_{hi}",
    build=lambda name, lo, hi: LCIPPConfig(
        name=name,
        progress_workers=lo,
        elastic_progress=(lo, hi),
        progress_mode="explicit" if lo == 0 else "implicit",
    ),
    canonical=((0, 2),),
    doc="elastic progress workers: pool adapts between {lo} and {hi} from reap occupancy",
))
# bounded-injection family (§3.3.4, ROADMAP follow-up): finite send ring +
# bounce pool, both `depth` deep, through the shared resource model.
REGISTRY.register_family(VariantSpec(
    grammar="lci_b{depth}",
    build=lambda name, depth: LCIPPConfig(
        name=name,
        limits=ResourceLimits(
            send_queue_depth=depth,
            bounce_buffers=depth,
            bounce_buffer_size=_B_FAMILY_BUF_SIZE,
        ),
    ),
    canonical=((4,), (16,), (64,)),
    doc="bounded injection: send ring + bounce pool {depth} deep",
))

#: dict-compatible view (legacy name); resolves family members on demand.
VARIANTS = RegistryView(REGISTRY)

# -- serving-fleet variants ------------------------------------------------
# A SEPARATE registry: fleet variants resolve to FleetConfig objects (the
# router+worker serving tier), not parcelport configs — they must never
# leak into `variant_names()`, which the benchmark smoke gate iterates
# through `make_parcelport_factory`/`deliver_payloads`.
SERVE_REGISTRY = VariantRegistry()


def _fleet_cfg(name: str, workers: int, transport: str):
    # lazy: repro_torch.serve pulls in torch and the models; variants must
    # stay importable without them
    from ..serve import FleetConfig

    del name  # the registry keys the cache; FleetConfig carries no name
    return FleetConfig(workers=workers, transport=transport)


for _n, _tr in (("fleet_inline", "inline"), ("fleet", "collective"), ("fleet_shmem", "shmem")):
    SERVE_REGISTRY.register(_n, lambda name=_n, tr=_tr: _fleet_cfg(name, 2, tr))
SERVE_REGISTRY.register_family(VariantSpec(
    grammar="fleet_w{n}",
    build=lambda name, n: _fleet_cfg(name, n, "collective"),
    canonical=((2,), (4,)),
    doc="router + {n} sharded-KV workers over the collective backend",
))
SERVE_REGISTRY.register_family(VariantSpec(
    grammar="fleet_shmem_w{n}",
    build=lambda name, n: _fleet_cfg(name, n, "shmem"),
    canonical=((2,), (4,)),
    doc="router + {n} workers, responses ride one-sided put (shmem backend)",
))


def _elastic_fleet_cfg(name: str, workers: int):
    from ..serve import FleetConfig

    del name
    # one spare pre-provisioned rank: join/leave cycles reuse it
    return FleetConfig(workers=workers, transport="collective", max_workers=workers + 1)


SERVE_REGISTRY.register_family(VariantSpec(
    grammar="fleet_elastic_w{n}",
    build=lambda name, n: _elastic_fleet_cfg(name, n),
    canonical=((2,),),
    doc="elastic fleet: {n} workers + one spare rank for membership join/leave",
))

#: dict-compatible view of the fleet family (resolves members on demand).
SERVE_VARIANTS = RegistryView(SERVE_REGISTRY)


def fleet_variant_names():
    return SERVE_REGISTRY.names()


def make_fleet_config(name: str):
    """Resolve a fleet variant name (fixed or family member, e.g.
    ``fleet_w4``) to a FRESH :class:`~repro_torch.serve.fleet.FleetConfig` —
    registry resolution is cached, and fleet configs are mutated by
    callers (slots/context sizing), so each caller gets its own copy."""
    from dataclasses import replace

    return replace(SERVE_VARIANTS[name])

_NO_LIMITS = ResourceLimits()


def variant_names():
    return ["mpi", "mpi_a"] + REGISTRY.names()


def variant_limits(name: str) -> ResourceLimits:
    """The shared resource model a variant calls for — what the fabric
    backing a :class:`~repro_torch.core.parcelport.World` should be built with.
    Unbounded for the MPI family and every variant that does not opt in."""
    if name in ("mpi", "mpi_a"):
        return _NO_LIMITS
    return VARIANTS[name].limits


def max_devices(name: str) -> int:
    if name in ("mpi", "mpi_a"):
        return 1
    return VARIANTS[name].ndevices


def make_parcelport_factory(name: str) -> Callable[[Locality, Fabric], Parcelport]:
    """Factory for :class:`repro_torch.core.parcelport.World`.  Resolves fixed
    names and parameterized family members (``lci_b8``, ``lci_d7``, …)
    without pre-registration."""
    if name == "mpi":
        return lambda loc, fab: MPIParcelport(loc, fab, aggregation=False)
    if name == "mpi_a":
        return lambda loc, fab: MPIParcelport(loc, fab, aggregation=True)
    cfg = VARIANTS[name]
    if name.startswith("collective"):
        # the collectives backend (imported lazily: it sits above the
        # parcelport layer this module belongs to)
        from .comm.collective import CollectiveParcelport

        return lambda loc, fab: CollectiveParcelport(loc, fab, cfg)
    if name.startswith("shmem"):
        # the shared-memory backend (the true one-sided put transport)
        from .comm.shmem import ShmemParcelport

        return lambda loc, fab: ShmemParcelport(loc, fab, cfg)
    return lambda loc, fab: LCIParcelport(loc, fab, cfg)
