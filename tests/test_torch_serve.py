"""Port parity: the serving path over the comm hand-off.

* Greedy token streams of the port's ``InferenceServer`` equal the JAX
  server's, on the ``inline`` and ``collective`` transports, with
  ``max_prefill=128`` and a 128-token prompt in the trace (routed, on the
  JAX side, through the Pallas kernel in interpret mode).
* ``encode_msg`` bytes equal the reference's.
* ``CommChannel`` parks posts on EAGAIN under a bounded ``ResourceLimits``
  and drains them in order.
* The same for ``mamba2-130m`` and ``zamba2-1.2b`` (SSM and hybrid), with
  fewer slots than requests, so recycled slots must start from zero SSM,
  conv and K/V state, single-shot and chunked.
* The launcher runs on the CPU when asked to."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.core.comm.wire import encode_msg as j_encode
from repro.models import init_params as j_init_params
from repro.serve import InferenceServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SMOKES
from repro_torch.core.comm.collective import CommChannel
from repro_torch.core.comm.interface import PostStatus
from repro_torch.core.comm.resources import ResourceLimits
from repro_torch.core.comm.wire import decode_msg, encode_msg
from repro_torch.launch.serve import main as serve_main
from repro_torch.serve import DecodeCore, InferenceServer, ServeConfig

torch.set_num_threads(1)

_rng = np.random.default_rng(7)
TRACE = [
    ([1, 2, 3], 4),
    ([4, 5], 5),
    (_rng.integers(0, 256, size=128).tolist(), 5),  # the Pallas route on the JAX side
    ([6, 7, 8, 9, 10, 11, 12, 13, 14], 6),
    ([2, 2], 4),
    (_rng.integers(0, 256, size=150).tolist(), 3),  # cut to max_prefill=128
    ([7, 7, 7, 7, 7, 7], 6),
]


def _serve(server):
    reqs = [server.submit(p, max_new=m) for p, m in TRACE]
    server.run_until_idle()
    assert all(r.done_event.is_set() for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def model():
    jcfg = J_SMOKES["tinyllama-1.1b"].variant(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, SMOKES["tinyllama-1.1b"].variant(dtype="float32"), jp, tp


@pytest.fixture(scope="module")
def jax_streams(model):
    jcfg, _, jp, _ = model
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_KERNELS", "pallas-interpret")
    try:
        return _serve(JServer(jcfg, jp, JServeConfig(slots=4, context=160, max_prefill=128, transport="inline")))
    finally:
        mp.undo()


@pytest.mark.parametrize("transport", ["inline", "collective"])
def test_token_streams_match_the_jax_server(model, jax_streams, transport):
    _, tcfg, _, tp = model
    server = InferenceServer(tcfg, tp, ServeConfig(slots=4, context=160, max_prefill=128, transport=transport))
    assert _serve(server) == jax_streams
    assert server.tokens_out == sum(m for _, m in TRACE)
    assert server.core.prefill_calls == len(TRACE)


@pytest.mark.parametrize("limits", [ResourceLimits(), ResourceLimits(send_queue_depth=1, retry_budget=1)])
def test_chunked_prefill_and_bounded_channel_keep_the_streams(model, jax_streams, limits):
    _, tcfg, _, tp = model
    server = InferenceServer(
        tcfg, tp,
        ServeConfig(slots=4, context=160, max_prefill=128, transport="collective", prefill_chunk=16, limits=limits),
    )
    assert _serve(server) == jax_streams
    assert server.core.prefill_calls == 0


def test_bad_requests_and_unported_transport_raise(model):
    _, tcfg, _, tp = model
    server = InferenceServer(tcfg, tp, ServeConfig(transport="inline"))
    with pytest.raises(ValueError):
        server.submit([], max_new=2)
    with pytest.raises(ValueError):
        server.submit([1], max_new=0)
    shmem = InferenceServer(tcfg, tp, ServeConfig(transport="shmem"))  # ported: responses ride one-sided puts
    assert shmem._channel._put_responses
    with pytest.raises(ValueError):
        InferenceServer(tcfg, tp, ServeConfig(transport="carrier-pigeon"))


MESSAGES = [
    (3, [1, 2, 3], 16),
    [(0, 17, False), (1, 255, True)],
    {"rid": 9, "prompt": [], "ok": None, "x": 1.5, "s": "héllo", "b": b"\x00\x01"},
    (np.int32(-4), np.float32(0.25), np.bool_(True), [[], ()]),
]


@pytest.mark.parametrize("msg", MESSAGES)
def test_encode_msg_bytes_equal_the_reference(msg):
    data = encode_msg(msg)
    assert data == j_encode(msg)
    assert decode_msg(data) == decode_msg(j_encode(msg))


def test_channel_parks_on_eagain_and_drains_in_order():
    ch = CommChannel(limits=ResourceLimits(send_queue_depth=2, retry_budget=1))
    n = 9
    for i in range(n):
        ch.send_request(encode_msg(i))
    assert ch.backpressure_parks() == n - 2
    assert ch.client.post_send(1, 0, 1, b"x", ch.response_cq) is PostStatus.EAGAIN_QUEUE
    got = []
    for _ in range(100):
        ch.drain_retries()
        ch.progress()
        while (rec := ch.reap("request")) is not None:
            ch.repost(rec.ctx)
            got.append(decode_msg(rec.data))
        if len(got) == n and not ch.pending_work():
            break
    # the sender-side send completions land in the response queue
    sends = 0
    while (rec := ch.reap("response")) is not None:
        assert rec.op == "send"
        sends += 1
    assert got == list(range(n)) and sends == n
    assert ch.group.stats.backpressure_events >= 2  # the first refused post and the direct one


def test_collective_server_under_two_client_threads(model):
    _, tcfg, _, tp = model
    server = InferenceServer(tcfg, tp, ServeConfig(slots=2, context=64, transport="collective",
                                                   limits=ResourceLimits(send_queue_depth=1)))
    reqs, lock = [], threading.Lock()

    def client(base):
        for i in range(4):
            r = server.submit([base + i, 3, 5], max_new=3)
            with lock:
                reqs.append(r)

    threads = [threading.Thread(target=client, args=(b,)) for b in (10, 20)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads) or not server.idle():
        server.step()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(reqs) == 8 and all(r.done_event.is_set() and len(r.out_tokens) == 3 for r in reqs)


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    rc = serve_main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--requests", "4", "--clients", "2",
                     "--max-new", "3", "--prompt-len", "5"])
    assert rc == 0
    assert "requests=4/4" in capsys.readouterr().out


# ------------------------------------------------------- SSM and hybrid
@pytest.fixture(scope="module", params=["mamba2-130m", "zamba2-1.2b"])
def ssm_model(request):
    name = request.param
    jcfg = J_SMOKES[name].variant(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, SMOKES[name].variant(dtype="float32"), jp, tp


def _jax_streams(jcfg, jp, prefill_chunk):
    return _serve(JServer(jcfg, jp, JServeConfig(slots=2, context=160, max_prefill=128, transport="inline",
                                                 prefill_chunk=prefill_chunk)))


@pytest.mark.parametrize("prefill_chunk", [0, 16])
def test_ssm_and_hybrid_streams_match_the_jax_server(ssm_model, prefill_chunk):
    """7 requests through 2 slots on both transports: every slot is
    recycled, and a leaked SSM, conv or K/V row would change the tokens."""
    jcfg, tcfg, jp, tp = ssm_model
    want = _jax_streams(jcfg, jp, prefill_chunk)
    for transport in ("inline", "collective"):
        server = InferenceServer(tcfg, tp, ServeConfig(slots=2, context=160, max_prefill=128, transport=transport,
                                                       prefill_chunk=prefill_chunk))
        assert _serve(server) == want, transport
        assert server.core.prefill_calls == (0 if prefill_chunk else len(TRACE))


def test_recycled_rows_start_from_zero_state():
    cfg = SMOKES["zamba2-1.2b"].variant(dtype="float32")
    core = DecodeCore(cfg, {"embed": torch.zeros(1)}, slots=3, context=32)
    leaves = [core.cache["ssm"]["ssm"], core.cache["ssm"]["conv"], *core.cache["shared_attn"].values()]
    for t in leaves:
        t.fill_(7)
    core._reset_row(1)
    for t in leaves:
        fresh = -1 if t is core.cache["shared_attn"]["pos"] else 0
        assert bool((t[:, 1] == fresh).all()) and bool((t[:, [0, 2]] == 7).all())
    one = {"ssm": {k: torch.full_like(v[:, :1], 3) for k, v in core.cache["ssm"].items()},
           "shared_attn": {k: torch.full_like(v[:, :1], 5) for k, v in core.cache["shared_attn"].items()}}
    core._splice(one, 2)
    assert bool((core.cache["ssm"]["conv"][:, 2] == 3).all()) and bool((core.cache["shared_attn"]["k"][:, 2] == 5).all())
    assert bool((core.cache["ssm"]["ssm"][:, 0] == 7).all())


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_launcher_serves_ssm_and_hybrid_on_the_cpu(arch, capsys):
    rc = serve_main(["--arch", arch, "--device", "cpu", "--requests", "4", "--clients", "2", "--slots", "2",
                     "--max-new", "3", "--prompt-len", "20"])
    assert rc == 0
    assert "requests=4/4" in capsys.readouterr().out


def _cache_err(jc, tc) -> float:
    """Largest |JAX - port| over the cache's leaves; position tags exactly."""
    assert set(jc) == set(tc)
    errs = [0.0]
    for key, jv in jc.items():
        if isinstance(jv, dict):
            errs.append(_cache_err(jv, tc[key]))
        elif key == "pos":
            assert np.array_equal(np.asarray(jv), tc[key].numpy())
        else:
            errs.append(float(np.max(np.abs(np.asarray(jv, np.float32) - tc[key].float().numpy()))))
    return max(errs)


def test_cache_and_pending_requests_match_the_jax_server(model):
    """The server's ``cache`` and ``pending_requests()`` against the
    reference's, step by step: 7 requests through 4 slots, so requests
    wait pending while others are slotted, and every row is recycled."""
    jcfg, tcfg, jp, tp = model
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_KERNELS", "pallas-interpret")
    try:
        js = JServer(jcfg, jp, JServeConfig(slots=4, context=160, max_prefill=128, transport="inline"))
        ts = InferenceServer(tcfg, tp, ServeConfig(slots=4, context=160, max_prefill=128, transport="inline"))
        for p, m in TRACE:
            js.submit(p, max_new=m)
            ts.submit(p, max_new=m)
        assert ts.pending_requests() == js.pending_requests() == len(TRACE)
        assert ts.cache is ts.core.cache
        seen = set()
        for _ in range(200):
            jstep, tstep = js.step(), ts.step()
            assert jstep == tstep
            assert ts.pending_requests() == js.pending_requests()
            assert _cache_err(js.cache, ts.cache) <= 1e-4
            seen.add((ts.pending_requests() > 0, ts.core.active()))
            if js.idle() and ts.idle():
                break
    finally:
        mp.undo()
    assert (True, True) in seen and ts.pending_requests() == 0  # pending beside slotted, then drained
