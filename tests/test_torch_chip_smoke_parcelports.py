"""``chip_smoke.py``'s phases 7 (the parcelport stack) and 8 (the DES
against it) run on the CPU.

The phase's three parts are functions of the script; here they run with
the collective group staged on the CPU (``device='cpu'``, the caller
asking for it) and with payloads of the same kinds made at a small size
without a card: a ``KIND_Q8`` wire from the port's host packer
(``pack_grads_q8``, bit for bit the device packer's bytes) and an ``RSNP``
snapshot of a prefilled mamba2 smoke slot.  On the card the same
functions carry the card's own bytes.  Phase 8's DES traces are also held
against the reference's DES on the same sizes, and each of its checks is
shown to fail on a differing trace, a flipped verdict or a launch."""
import copy
import importlib.util
import threading
from pathlib import Path

import pytest
import torch

from repro.amtsim import parcelport_sim as jsim
from repro_torch.checkpoint.snapshot import pack_state
from repro_torch.configs import SMOKES
from repro_torch.core.comm.membership import live_worker_count
from repro_torch.core.comm.wire import KIND_Q8, parse_grad_header
from repro_torch.models import init_params
from repro_torch.serve import DecodeCore, Request
from repro_torch.train.grad_sync import pack_grads_q8
from test_torch_progress_engine import des_trace

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def payloads():
    """A KIND_Q8 wire of a small gradient tree and an RSNP snapshot of one
    mamba2 smoke slot after a prefill, as phase 7(b)'s kinds of bytes."""
    gen = torch.Generator().manual_seed(0)
    grads = {"a": torch.randn(300, 70, generator=gen), "b": {"c": torch.randn(4_097, generator=gen)}}
    ef = {"a": torch.zeros(300, 70), "b": {"c": torch.zeros(4_097)}}
    wire, _ = pack_grads_q8(grads, ef)
    arch = SMOKES["mamba2-130m"].variant(dtype="float32")
    core = DecodeCore(arch, init_params(torch.Generator().manual_seed(0), arch), slots=2, context=64)
    core.admit(Request(rid=7, prompt=[3, 1, 4, 1, 5, 9, 2, 6], max_new=4), lambda *a: None)
    state, meta = core.extract_slot(0)
    snap = pack_state(state, meta)
    assert parse_grad_header(wire)[0] == KIND_Q8 and snap[:4] == b"RSNP"
    return [bytes(wire), snap]


def test_phase7a_protocol_gate_over_the_port(smoke, capsys):
    counts = smoke.parcelport_gate()
    assert set(counts) >= {"lci", "mpi", "collective", "shmem_putq", "lci_eprg0_2"}
    assert counts["lci_eager"]["messages"] < counts["lci_noeager"]["messages"]
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("parcelport ")]
    assert len(lines) == len(counts)  # one line of message counts a variant


def test_phase7b_carries_the_payloads_through_every_carrier(smoke, payloads):
    out = smoke.parcelport_carry(payloads, "cpu")
    assert set(out) == set(smoke.PP_CARRIERS)
    coll = out["collective"]
    assert coll["staged_batches"] >= 1 and coll["staged_bytes"] == coll["bytes"] - 8 * coll["sends"]
    for name in ("lci", "mpi", "shmem_putq"):
        assert out[name]["staged_batches"] == 0
        assert out[name]["rendezvous"] >= 2  # header and zero-copy follow-up, a payload
    assert out["shmem_putq"]["puts"] > 0 and out["lci"]["puts"] > 0 and out["mpi"]["puts"] == 0


def test_phase7b_fails_on_a_corrupted_delivery(smoke, payloads, monkeypatch):
    """The bit-for-bit check bites: a sink that flips a byte fails the phase."""
    real = smoke._pp_delivered
    monkeypatch.setattr(smoke, "_pp_delivered", lambda got: [b"\x00" + p[1:] for p in real(got)])
    with pytest.raises(SystemExit):
        smoke.parcelport_carry(payloads, "cpu")


def test_phase7c_elastic_pool_in_bounds_and_closed(smoke):
    base, census = threading.active_count(), live_worker_count()
    out = smoke.parcelport_elastic()
    assert all(0 <= n <= 2 for n in out["pool_sizes"])
    assert threading.active_count() <= base + 1 and live_worker_count() == census


def test_phase7_launches_no_kernel(smoke, payloads):
    class Counted:
        launches = 5

    kernels = {"flash_attention": Counted(), "grad_pack": Counted()}
    assert smoke.parcelport_path(kernels, payloads, "cpu") == {"flash_attention": 0, "grad_pack": 0}


class Counted:
    launches = 5


def test_phase8a_des_agrees_with_the_functional_stack(smoke, payloads, capsys):
    lengths = smoke.des_agreement(payloads)
    assert set(lengths) == set(smoke.DES_CARRIERS) and all(n == 8 for n in lengths.values())
    sizes = [len(p) for p in payloads]
    for name in smoke.DES_CARRIERS:  # the script's DES trace is the reference DES's
        tr = smoke.des_trace(name, sizes)
        assert tr == des_trace(name, sizes) == des_trace(name, sizes, sim=jsim)
        assert [e for e in tr if e[0] == "send"] == [("send", "rdv", 1)] * 2
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("phase 8(a) ")]
    assert len(lines) == len(smoke.DES_CARRIERS) and all("equal: True" in ln for ln in lines)


def test_phase8a_fails_on_a_differing_trace(smoke, payloads, monkeypatch):
    real = smoke.des_trace
    monkeypatch.setattr(smoke, "des_trace", lambda name, sizes: real(name, sizes)[:-1])
    with pytest.raises(SystemExit):
        smoke.des_agreement(payloads)


def test_phase8_holds_the_verdicts_and_launches_no_kernel(smoke, payloads, capsys):
    kernels = {"flash_attention": Counted(), "grad_pack": Counted()}
    assert smoke.des_path(kernels, payloads) == {"flash_attention": 0, "grad_pack": 0}
    out = capsys.readouterr().out
    assert "phase 8(b): 7 of 7 of the paper's verdicts hold" in out
    assert "simulated, expanse model" in out and "delta/expanse" in out


VERDICTS_HOLD = {
    "flood_8": {"lci": 9.0e6, "mpi": 3.3e5, "mpi_a": 3.2e6},
    "flood_16k": {"lci": 7.5e5, "mpi": 1.3e5, "mpi_a": 2.3e5},
    "chains": {"lci": 2.7e-6, "mpi": 1.0e-5},
    "ladder": {"block": 3.2e5, "try_progress": 3.5e5, "lci": 9.0e6},
    "devices": {"lci_d1": 4.5e6, "lci_d4": 1.8e7},
    "octotiger": {"lci": 6.0e-4, "mpi": 1.4e-3},
    "platforms": {"expanse": 9.0e6, "delta": 1.1e6},
}
FLIPS = {
    "flood order": ("flood_8", "mpi_a", 3.0e5),
    "aggregation gain": ("flood_16k", "mpi_a", 1.3e6),
    "latency": ("chains", "lci", 2.0e-5),
    "ladder": ("ladder", "try_progress", 3.0e5),
    "devices": ("devices", "lci_d4", 6.0e6),
    "octotiger": ("octotiger", "mpi", 5.0e-4),
    "slingshot": ("platforms", "delta", 9.5e6),
}


@pytest.mark.parametrize("flip", sorted(FLIPS))
def test_phase8b_fails_on_a_flipped_verdict(smoke, flip):
    smoke.check_des_verdicts(VERDICTS_HOLD)  # the unflipped numbers pass
    r = copy.deepcopy(VERDICTS_HOLD)
    group, key, value = FLIPS[flip]
    r[group][key] = value
    with pytest.raises(SystemExit):
        smoke.check_des_verdicts(r)


def test_phase8_fails_on_a_launch(smoke, payloads, monkeypatch):
    kernels = {"flash_attention": Counted()}

    def launch():
        kernels["flash_attention"].launches += 1

    monkeypatch.setattr(smoke, "des_agreement", lambda payloads: launch())
    monkeypatch.setattr(smoke, "des_verdicts", lambda: None)
    with pytest.raises(SystemExit):
        smoke.des_path(kernels, payloads)
