"""``chip_smoke.py``'s phase 7 (the parcelport stack) run on the CPU.

The phase's three parts are functions of the script; here they run with
the collective group staged on the CPU (``device='cpu'``, the caller
asking for it) and with payloads of the same kinds made at a small size
without a card: a ``KIND_Q8`` wire from the port's host packer
(``pack_grads_q8``, bit for bit the device packer's bytes) and an ``RSNP``
snapshot of a prefilled mamba2 smoke slot.  On the card the same
functions carry the card's own bytes."""
import importlib.util
import threading
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint.snapshot import pack_state
from repro_torch.configs import SMOKES
from repro_torch.core.comm.membership import live_worker_count
from repro_torch.core.comm.wire import KIND_Q8, parse_grad_header
from repro_torch.models import init_params
from repro_torch.serve import DecodeCore, Request
from repro_torch.train.grad_sync import pack_grads_q8

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
