"""Port parity: ONE progress engine across the port's functional core and
its DES.

``tests/test_progress_engine.py``'s DES half on ``repro_torch``: both of
the port's layers drive ``repro_torch.core.comm.progress.ProgressEngine``,
so on the same variant and workload the port's DES ``des_trace``, the
port's functional ``functional_trace`` (``tests/test_torch_protocol_engine.py``)
and the reference's DES ``des_trace`` replay one ordered decision trace.
Plus ``sim_config_for_variant`` and its family resolution (every name of
``variant_names()`` resolves to the reference's ``SimConfig``), the
dedicated-progress family in the DES, ``cq_scope``, the ``rnr_storm``
model, the exhaustive field mapping and the engine-thin gate."""
import dataclasses

import pytest

from repro.amtsim import parcelport_sim as jsim
from repro_torch.amtsim import parcelport_sim as tsim
from repro_torch.amtsim.parcelport_sim import (
    SHARED_CONFIG_FIELDS,
    SimConfig,
    SimWorld,
    sim_config_for_variant,
)
from repro_torch.amtsim.workloads import flood
from repro_torch.core.comm.progress import ProgressEngine, ProgressPolicy
from repro_torch.core.comm.resources import ResourceLimits
from repro_torch.core.lci_parcelport import LCIPPConfig, LCIParcelport
from repro_torch.core.mpi_parcelport import MPIParcelport
from repro_torch.core.variants import VARIANTS, variant_names
from test_torch_protocol_engine import PARITY_SIZES, functional_trace

# tests/test_progress_engine.py's PARITY_VARIANTS
PARITY_VARIANTS = ("lci", "lci_agg_eager", "mpi", "lci_prg2",
                   "shmem", "shmem_put", "shmem_putq", "shmem_prg2")


def des_trace(variant: str, sizes=PARITY_SIZES, sim=tsim) -> list:
    """Run ``sim``'s DES (the port's by default) with the variant's config,
    chained sequentially (each send spawned by the previous delivery), and
    return the engine's trace."""
    world = sim.SimWorld(2, 4, sim.sim_config_for_variant(variant))
    tr: list = []
    world.engine.trace = tr
    state = {"i": 0}

    def send_next() -> None:
        if state["i"] >= len(sizes):
            world.stop()
            return
        size = sizes[state["i"]]
        state["i"] += 1
        op = world.make_parcel(0, 1, size, on_delivered=send_next)
        world.spawn(0, sim.Task(action=lambda w, _op=op: world.send_parcel(w, _op)))

    send_next()
    world.run(until=5.0)
    assert world.stopped and state["i"] == len(sizes)
    return tr


# ------------------------------------------------- one engine, three traces
@pytest.mark.parametrize("variant", PARITY_VARIANTS)
def test_engine_parity_functional_vs_des(variant):
    """Same variant, same workload: the port's functional core, the port's
    DES and the reference's DES replay identical ordered decision traces."""
    port_des = des_trace(variant)
    assert port_des == functional_trace(variant)
    assert port_des == des_trace(variant, sim=jsim)
    assert port_des.count(("deliver", 1)) == len(PARITY_SIZES)


@pytest.mark.parametrize("variant", variant_names())
def test_des_trace_and_config_equal_the_reference_on_every_variant(variant):
    """Every name of the registry: the port's ``sim_config_for_variant``
    equals the reference's field for field, and the two DES traces agree."""
    assert dataclasses.asdict(sim_config_for_variant(variant)) == dataclasses.asdict(
        jsim.sim_config_for_variant(variant))
    assert des_trace(variant) == des_trace(variant, sim=jsim)


def test_des_drives_the_ports_engine():
    """The DES engine is the class the port's functional parcelports run,
    not a copy inside ``amtsim``."""
    from repro_torch.core.comm import progress

    assert tsim.ProgressEngine is progress.ProgressEngine is ProgressEngine
    assert tsim.LCIPPConfig is LCIPPConfig and tsim.VARIANTS is VARIANTS
    assert tsim.ResourceLimits is ResourceLimits
    world = SimWorld(2, 4, sim_config_for_variant("lci"))
    assert type(world.engine) is ProgressEngine


# ------------------------------------------------- policy / router units
def test_policy_for_config_parity_across_layers():
    """ONE policy builder serves both layers: the functional LCIPPConfig
    and the DES SimConfig for the same variant yield the same policy."""
    for name in ("lci", "try_progress", "block", "lci_prg2"):
        functional = ProgressPolicy.for_config(VARIANTS[name])
        des = ProgressPolicy.for_config(sim_config_for_variant(name))
        assert functional == des, name
    assert ProgressPolicy.for_config(sim_config_for_variant("mpi")) == ProgressPolicy.mpi_request_pool()


# --------------------------------------- dedicated progress workers (prg)
def test_des_dedicated_progress_workers_deliver():
    r = flood("lci_prg2", msg_size=64, nthreads=8, nmsgs=300)
    assert r.messages == 300


def test_des_rejects_all_workers_dedicated():
    """Reserving every core for the engine leaves nobody to run tasks —
    fail fast instead of silently spinning to the time cap."""
    with pytest.raises(ValueError, match="progress_workers"):
        SimWorld(2, 2, sim_config_for_variant("lci_prg2"))


# --------------------------------------------- completion-router scope
def test_cq_scope_device_des_deterministic():
    cfg = dataclasses.replace(sim_config_for_variant("lci"), name="lci_devcq", cq_scope="device")
    r1 = flood(cfg, msg_size=8, nthreads=8, nmsgs=300)
    r2 = flood(cfg, msg_size=8, nthreads=8, nmsgs=300)
    assert r1.messages == 300 and (r1.elapsed, r1.messages) == (r2.elapsed, r2.messages)


# ------------------------------------------------------------ rnr_storm
def _rnr_cfg(storm: bool) -> SimConfig:
    return dataclasses.replace(
        sim_config_for_variant("lci"),
        name="lci_rnr_storm" if storm else "lci_rnr",
        rnr_storm=storm,
        limits=ResourceLimits(recv_slots=1),
    )


def test_rnr_storm_charges_retries_and_loses_nothing():
    """§3.1: storm mode retransmits RNR'd arrivals under exponential
    backoff on t_rnr_retry — counted per retry, slower than free
    redelivery-on-reap, and still lossless."""
    free = flood(_rnr_cfg(False), msg_size=64, nthreads=8, nmsgs=300, max_seconds=4.0)
    storm = flood(_rnr_cfg(True), msg_size=64, nthreads=8, nmsgs=300, max_seconds=4.0)
    assert free.rnr_events > 0 and free.rnr_retries == 0  # default: free redelivery
    assert storm.rnr_retries > 0  # every retransmission counted
    assert storm.messages == 300  # retried, never lost
    assert storm.elapsed > free.elapsed  # retries burn wire time
    assert storm.rnr_events >= free.rnr_events  # refused retries re-count


def test_rnr_storm_flag_is_inert_without_recv_slots():
    """Unbounded model bit-identical: the storm flag takes no code path
    unless limits.recv_slots bounds the receive side."""
    base = sim_config_for_variant("lci")
    r0 = flood(base, msg_size=64, nthreads=8, nmsgs=300)
    r1 = flood(dataclasses.replace(base, rnr_storm=True), msg_size=64, nthreads=8, nmsgs=300)
    assert (r0.elapsed, r0.messages, r0.rnr_events, r0.rnr_retries) == (
        r1.elapsed, r1.messages, r1.rnr_events, r1.rnr_retries,
    )


def test_rnr_storm_deterministic():
    cfg = _rnr_cfg(True)
    r1 = flood(cfg, msg_size=64, nthreads=8, nmsgs=300, max_seconds=4.0)
    r2 = flood(cfg, msg_size=64, nthreads=8, nmsgs=300, max_seconds=4.0)
    assert (r1.elapsed, r1.rnr_retries) == (r2.elapsed, r2.rnr_retries)


def test_rnr_retries_in_injection_stats():
    world = SimWorld(2, 4, _rnr_cfg(True))
    assert "rnr_retries" in world.injection_stats()


# ---------------------------------- sim_config_for_variant (regression)
def test_sim_config_resolves_family_members_via_registry():
    """Parameterized family names resolve through the port's registry, and
    every shared axis is carried over — not just the fixed names."""
    prg = sim_config_for_variant("lci_prg2")
    assert prg.progress_workers == 2 and prg.progress_mode == "implicit"
    b8 = sim_config_for_variant("lci_b8")
    assert b8.limits is VARIANTS["lci_b8"].limits  # SAME object, never a copy
    eager = sim_config_for_variant("lci_eager_32k")
    assert eager.eager_threshold == 32 * 1024
    with pytest.raises(KeyError):
        sim_config_for_variant("lci_prgx")


@pytest.mark.parametrize("name", ["lci_b8", "lci_prg3", "lci_eager_32k", "lci_d6", "lci_try_d3", "lci_eprg1_3",
                                  "collective_prg3", "shmem_prg1"])
def test_family_members_resolve_as_the_reference(name):
    """Members no fixed name lists resolve on demand to the reference's
    SimConfig."""
    assert dataclasses.asdict(sim_config_for_variant(name)) == dataclasses.asdict(jsim.sim_config_for_variant(name))


def test_shared_config_fields_exhaustive():
    """Drift guard: every LCIPPConfig axis except the name must be mapped
    into SimConfig (a new functional knob that the DES silently ignores is
    exactly the bug the one-engine contract exists to prevent)."""
    lci_fields = {f.name for f in dataclasses.fields(LCIPPConfig)} - {"name"}
    assert lci_fields == set(SHARED_CONFIG_FIELDS)
    sim_fields = {f.name for f in dataclasses.fields(SimConfig)}
    assert set(SHARED_CONFIG_FIELDS) <= sim_fields
    assert SHARED_CONFIG_FIELDS == jsim.SHARED_CONFIG_FIELDS


# ------------------------------------------------- the engine-thin gate
def test_background_work_is_engine_thin():
    """Both functional parcelports' background_work are thin run_step
    calls."""
    for cls in (LCIParcelport, MPIParcelport):
        assert "run_step" in cls.background_work.__code__.co_names


def test_analyzer_engine_gate_green():
    """The port analyzer's gate-progress-engine over ``src/repro_torch``
    (the counterpart of the reference's ``check_api`` engine gate) finds
    nothing, and it did read the DES and both parcelports."""
    from pathlib import Path

    from repro_torch.analysis.registry import AnalysisContext, run_passes

    ctx = AnalysisContext.for_repo(Path(__file__).resolve().parent.parent)
    for suffix in ("amtsim/parcelport_sim.py", "core/lci_parcelport.py", "core/mpi_parcelport.py"):
        assert ctx.module_at(suffix).path == f"src/repro_torch/{suffix}"
    assert run_passes(ctx, ["gate-progress-engine"]) == []
