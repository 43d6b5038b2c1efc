"""The decode step replayed from CUDA graphs (``models/decode_graph.py``).

On the CPU (tier 1):

* ``out=`` of ``ops.expert_ffn_matmul`` and ``grouped_matmul_plain``: the
  product is written into ``out``, which is returned; a wrong shape or
  dtype raises.
* A ``DecodeCore`` on the CPU, of a full tile or of 4 slots, builds no
  runner and serves the tokens of the eager model API.
* Where a runner cuts its capture: three kernel calls a MoE layer (gate,
  up, down), none for the dense, SSM, hybrid and MLA families.

On the card (``gpu``-marked; each skips without one):

* Every family ``DecodeCore`` serves, at its smoke size in bf16, and
  deepseek-moe-16b at full width (single-shot and chunked prefill): over
  20 steps with admissions and finishes between them, the replayed step's
  logits and the served tokens equal the eager ``decode_step``'s on a twin
  core, bit for bit.
* After construction the cache equals a fresh ``init_cache``.
* ``grouped_matmul.launches`` grows by 3 a MoE layer a replayed step (84
  on deepseek-moe-16b), and a card-only profiler session over replayed
  steps holds one ``gmm_kernel`` record a launch and the eager step's busy
  time within 5%.

Imports no jax: on a machine without JAX run it with ``--noconftest``."""
import contextlib

import pytest
import torch

from repro_torch.configs import SMOKES, get_config
from repro_torch.kernels import grouped_matmul, grouped_matmul_plain, ops
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.decode_graph import DecodeGraph, entry_calls
from repro_torch.serve import DecodeCore
from repro_torch.serve import server as server_mod
from repro_torch.serve.server import Request
from repro_torch.tree import leaves

SERVED = ["tinyllama-1.1b", "mamba2-130m", "zamba2-1.2b", "minicpm3-4b", "internvl2-76b",
          "llama4-scout-17b-a16e", "deepseek-moe-16b"]
# (engine step at which the request is admitted, prompt, max_new): finishes and
# admissions fall between steps, and slots are recycled
SCHEDULE = [(0, [1, 2, 3], 6), (0, [4, 5], 20), (0, [9, 8, 7, 6, 5, 4, 3, 2, 1], 3), (0, [2, 2], 12),
            (0, [7] * 6, 9), (0, [3, 1, 4, 1, 5], 15), (0, [11, 12], 4), (0, [5, 6, 7], 20),
            (4, [13, 14, 15], 8), (4, [1, 1], 16), (9, [6, 5, 4, 3], 11), (13, [8, 8, 8], 6)]


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("entry", ["expert_ffn_matmul", "grouped_matmul_plain"])
def test_out_receives_the_product(entry):
    fn = ops.expert_ffn_matmul if entry == "expert_ffn_matmul" else grouped_matmul_plain
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(3, 5, 4, generator=g), torch.randn(3, 4, 6, generator=g)
    out = torch.full((3, 5, 6), float("nan"))
    got = fn(x, w, out=out)
    assert got is out and torch.equal(out, grouped_matmul_plain(x, w))
    with pytest.raises(ValueError, match="out must be"):
        fn(x, w, out=torch.empty(3, 5, 5))
    with pytest.raises(ValueError, match="out must be"):
        fn(x, w, out=torch.empty(3, 5, 6, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="out must be"):
        fn(x, w, out=torch.empty(3, 6, 5).transpose(1, 2))


def _greedy(params, arch, prompt, max_new, context):
    """``prompt``'s greedy answer through the model API: its prefill, then
    ``decode_step`` on its own row."""
    one = init_cache(arch, 1, context, "cpu")
    with torch.inference_mode():
        logits, one = prefill(params, arch, {"tokens": torch.tensor([prompt])}, one)
        out = [int(logits[0, -1].argmax())]
        for i in range(max_new - 1):
            logits, one = decode_step(params, arch, torch.tensor([[out[-1]]]),
                                      torch.tensor([len(prompt) + i], dtype=torch.int32), one)
            out.append(int(logits[0, 0].argmax()))
    return out


def _drive(core, schedule, steps):
    """Admit ``schedule``'s requests at their steps (into free slots, the
    rest wait) and run ``steps`` engine steps; returns each request's tokens."""
    reqs = [Request(rid=i, prompt=p, max_new=m) for i, (_, p, m) in enumerate(schedule)]
    waiting = list(zip((at for at, _, _ in schedule), reqs))

    def emit(req, tok, done):
        req.out_tokens.append(tok)

    for step in range(steps):
        while waiting and waiting[0][0] <= step and core.free_slots():
            core.admit(waiting.pop(0)[1], emit)
        core.step(emit)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("slots", [8, 4])
def test_cpu_core_builds_no_runner_and_serves_the_model_apis_tokens(slots):
    torch.manual_seed(0)
    arch = SMOKES["deepseek-moe-16b"].variant(dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), arch)
    core = DecodeCore(arch, params, slots=slots, context=64)
    assert (core.graph_pieces, core.graph_steps) == (0, 0)
    assert DecodeGraph.on(params, core.cache) is None
    schedule = SCHEDULE[:6]
    got = _drive(core, schedule, 24)
    assert core.steps > 0 and core.graph_steps == 0
    assert got == [_greedy(params, arch, p, m, 64) for _, p, m in schedule]


@pytest.mark.parametrize("name,per_layer", [("deepseek-moe-16b", 3), ("llama4-scout-17b-a16e", 3),
                                            ("tinyllama-1.1b", 0), ("mamba2-130m", 0), ("zamba2-1.2b", 0),
                                            ("minicpm3-4b", 0)])
def test_cuts_are_the_expert_products(name, per_layer):
    arch = SMOKES[name].variant(dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), arch)
    calls = entry_calls(params, arch, init_cache(arch, 8, 16, "cpu"))
    assert calls == ["expert_ffn_matmul"] * per_layer * arch.n_layers


def test_server_decode_step_is_the_models_without_a_runner():
    arch = SMOKES["mamba2-130m"].variant(dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), arch)
    toks, pos = torch.tensor([[3]] * 8), torch.zeros(8, dtype=torch.int32)
    a, b = init_cache(arch, 8, 16, "cpu"), init_cache(arch, 8, 16, "cpu")
    with torch.inference_mode():
        got, cache = server_mod.decode_step(params, arch, toks, pos, a)
        want, _ = decode_step(params, arch, toks, pos, b)
    assert cache is a and torch.equal(got, want)
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


# ----------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@contextlib.contextmanager
def _recording(logits, eager):
    """``server.decode_step`` keeps a copy of each step's logits; with
    ``eager`` it is ``models.decode_step`` (a twin core's step, not replayed)."""
    real = server_mod.decode_step
    dec = decode_step if eager else real

    def rec(params, arch, tokens, positions, cache):
        out, cache = dec(params, arch, tokens, positions, cache)
        logits.append(out.clone())
        return out, cache

    server_mod.decode_step = rec
    try:
        yield
    finally:
        server_mod.decode_step = real


def _replayed_equals_eager(arch, params, context, prefill_chunk=0):
    cores = [DecodeCore(arch, params, slots=8, context=context, max_prefill=context // 2, prefill_chunk=prefill_chunk)
             for _ in range(2)]
    assert cores[0].graph_pieces >= 1
    runs = []
    for core, eager in zip(cores, (False, True)):
        logits = []
        with _recording(logits, eager):
            tokens = _drive(core, SCHEDULE, 20)
        runs.append((tokens, logits))
    (tokens, logits), (tokens_e, logits_e) = runs
    assert cores[0].graph_steps == cores[0].steps == cores[1].steps >= 18 and cores[1].graph_steps == 0
    assert len(logits) == len(logits_e) == cores[0].steps
    assert all(torch.equal(a, b) for a, b in zip(logits, logits_e))  # bit for bit
    assert tokens == tokens_e and sum(map(len, tokens)) > 100


@pytest.fixture(scope="module")
def deepseek_full():
    _card()
    arch = get_config("deepseek-moe-16b")
    return arch, init_params(torch.Generator(device="cuda").manual_seed(0), arch)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SERVED)
def test_cuda_replayed_steps_equal_eager_steps(name):
    _card()
    arch = SMOKES[name].variant(dtype="bfloat16")
    _replayed_equals_eager(arch, init_params(torch.Generator(device="cuda").manual_seed(0), arch), 64)


@pytest.mark.gpu
@pytest.mark.parametrize("prefill_chunk", [0, 4])
def test_cuda_full_width_deepseek_replays_the_eager_step(deepseek_full, prefill_chunk):
    _replayed_equals_eager(*deepseek_full, 256, prefill_chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SERVED)
def test_cuda_construction_leaves_a_fresh_cache(name):
    _card()
    arch = SMOKES[name].variant(dtype="bfloat16")
    core = DecodeCore(arch, init_params(torch.Generator(device="cuda").manual_seed(0), arch), slots=8, context=64)
    fresh = init_cache(arch, 8, 64, "cuda")
    assert core.graph_pieces >= 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(core.cache), leaves(fresh)))


def _busy_s(prof):
    """Seconds in which any kernel or copy ran on the card, and the
    ``gmm_kernel`` records."""
    from torch.autograd import DeviceType

    dev = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy, cur = 0.0, None
    for s, e in dev:
        if cur is None or s > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += 0 if cur is None else cur[1] - cur[0]
    return busy / 1e6, sum("gmm_kernel" in n for n in names)


@pytest.mark.gpu
def test_cuda_replayed_kernels_are_launched_counted_and_traced(deepseek_full):
    from torch.profiler import ProfilerActivity, profile

    arch, params = deepseek_full
    core = DecodeCore(arch, params, slots=8, context=256)
    _drive(core, [(0, [5 + i, 6, 7], 100) for i in range(8)], 3)  # every slot decoding
    n = 4
    per_step = {}
    for eager in (False, True, False, True):
        logits = []
        with _recording(logits, eager):
            torch.cuda.synchronize()
            launches = grouped_matmul.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    core.step(lambda req, tok, done: None)
                torch.cuda.synchronize()
        busy, gmm = _busy_s(prof)
        assert grouped_matmul.launches - launches == 3 * arch.n_layers * n == 84 * n
        assert gmm == 84 * n, (eager, gmm)
        per_step.setdefault(eager, []).append(busy / n)
    replayed, eager = min(per_step[False]), min(per_step[True])
    assert abs(replayed - eager) <= 0.05 * eager, per_step
