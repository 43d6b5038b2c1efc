"""A record: one stalled chunked-prefill ``mamba2`` schedule, on the
reference's ``DecodeCore`` and on the port's (smoke config, CPU).

A prefilling slot whose next chunk has not arrived is *starved*: both
cores re-feed its last token and hold its position.  The reference lets
that step write the slot's cache row (``src/repro/serve/server.py``,
``DecodeCore.step``), which is harmless for a position-addressed K/V ring
but advances an SSM's state and conv window by a token that is not part
of the prompt.  The port puts the starved row back as it was before the
step (``src/repro_torch/serve/server.py``, ``DecodeCore.step``).

So on the same schedule, stalled 3 steps against never stalled, the
reference's slot reaches the end of its prompt with a different SSM and
conv state, and the port's with the same one, bit for bit; the port's
token stream equals its unstalled run.  This records the difference; it
repairs nothing in either package.  At the smoke config (tied
embeddings, random weights) the argmax of every step repeats the input
token, so the reference's tokens happen to agree here: the departure is
recorded where it happens, in the row the next tokens are computed from.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.models import init_params as j_init_params
from repro.serve.server import DecodeCore as JDecodeCore
from repro.serve.server import Request as JRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SMOKES
from repro_torch.serve import DecodeCore, Request

torch.set_num_threads(1)

ARCH = "mamba2-130m"
PROMPT, MAX_NEW, CHUNK, STALL = [6, 7, 8, 9, 10, 11, 12, 13, 14], 5, 4, 3


@pytest.fixture(scope="module")
def pair():
    jcfg = J_SMOKES[ARCH].variant(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, SMOKES[ARCH].variant(dtype="float32"), params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def run(core_cls, req_cls, arch, params, stall):
    """Admit the prompt's first chunk (slot 0) beside a decoding neighbour
    (slot 1), step through the chunk and ``stall`` starved steps, feed the
    rest; returns slot 0's stream and its cache row (SSM and conv state,
    as float64 numpy) when its first token is emitted: both cores emit
    after the step's cache update, so that is the state after the last
    prompt token."""
    core = core_cls(arch, params, slots=2, context=64, prefill_chunk=CHUNK)
    out, row = [], {}

    def emit(req, tok, done):
        if req.rid != 0:
            return
        if not out:  # the last prompt token was just consumed
            row.update({k: np.asarray(v[:, 0], np.float64).copy() for k, v in core.cache["ssm"].items()})
        out.append(tok)

    core.admit(req_cls(rid=0, prompt=PROMPT[:CHUNK], max_new=MAX_NEW), emit, more_chunks=True)
    core.admit(req_cls(rid=1, prompt=[1, 2, 3], max_new=MAX_NEW + STALL + len(PROMPT)), emit)
    for _ in range(CHUNK + stall):  # the first chunk, then `stall` starved steps
        core.step(emit)
    assert core.prefilling(0)
    core.feed_chunk(0, PROMPT[CHUNK:], last=True)
    while len(out) < MAX_NEW:
        core.step(emit)
    return out, row


def _max_diff(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def test_the_reference_state_departs_on_a_stall_and_the_port_holds(pair):
    jcfg, jp, tcfg, tp = pair
    j_stream0, j_row0 = run(JDecodeCore, JRequest, jcfg, jp, stall=0)
    j_stream, j_row = run(JDecodeCore, JRequest, jcfg, jp, stall=STALL)
    t_stream0, t_row0 = run(DecodeCore, Request, tcfg, tp, stall=0)
    t_stream, t_row = run(DecodeCore, Request, tcfg, tp, stall=STALL)
    assert set(j_row0) == set(t_row0) == {"conv", "ssm"}
    # the reference: the starved steps advanced the SSM and conv state
    j_departs = {k: float(np.max(np.abs(j_row[k] - j_row0[k]))) for k in j_row}
    assert j_departs["ssm"] > 1e-3 and j_departs["conv"] > 1e-3, j_departs
    # the port: the same state as never stalled, bit for bit, and the same stream
    assert all(np.array_equal(t_row[k], t_row0[k]) for k in t_row)
    assert t_stream == t_stream0
    # the two packages agree where neither stalled
    assert _max_diff(t_row0, j_row0) < 1e-4
    assert t_stream0 == j_stream0
    print(f"reference row departure after {STALL} starved steps: {j_departs}; "
          f"reference streams {j_stream0} / {j_stream}; port {t_stream0} / {t_stream}")
