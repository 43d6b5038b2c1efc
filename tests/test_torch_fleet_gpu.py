"""The fleet on the card (``gpu``-marked; each skips without a card).

* Rows of ``decode_step`` are bit-identical at batch 1, 2, 4 and 8 for
  ``tinyllama-1.1b`` and ``mamba2-130m`` at smoke size in bf16.
* A 2-worker fleet whose worker 0 leaves mid-decode (its slots handed off
  as snapshot bytes) and whose spare rank joins emits the streams of the
  same fleet without churn and of a single host, over the collective and
  the shared-memory transports.

Imports no jax: on a machine without JAX run it with ``--noconftest``."""
import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.models import decode_step, init_cache, init_params

TRACE = [
    ([1, 2, 3], 4),
    ([4, 5], 5),
    ([6, 7, 8, 9, 10, 11, 12, 13, 14], 6),
    ([2, 2], 4),
    ([9, 1, 4], 5),
    ([7, 7, 7, 7, 7, 7], 6),
]


def _model(name):
    arch = SMOKES[name].variant(dtype="bfloat16")
    return arch, init_params(torch.Generator(device="cuda").manual_seed(0), arch)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "mamba2-130m"])
def test_cuda_decode_rows_independent_of_batch_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arch, params = _model(name)
    start = torch.tensor([[3], [5], [7], [9], [11], [13], [2], [4]], device="cuda")
    runs = {}
    with torch.inference_mode():
        for b in (1, 2, 4, 8):
            cache = init_cache(arch, b, 64, "cuda")
            toks, pos, out = start[:b], torch.zeros(b, dtype=torch.long, device="cuda"), []
            for _ in range(4):
                logits, cache = decode_step(params, arch, toks, pos, cache)
                out.append(logits[:, 0])
                toks, pos = logits[:, 0].argmax(-1)[:, None], pos + 1
            runs[b] = torch.stack(out, 1)
    for b in (1, 2, 4):
        assert torch.equal(runs[b], runs[8][:b]), b  # bit-exact, not approximate


@pytest.mark.gpu
@pytest.mark.parametrize("transport", ["collective", "shmem"])
def test_cuda_fleet_mid_decode_handoff_matches_no_churn(transport):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serve import Fleet, FleetConfig, InferenceServer, ServeConfig

    arch, params = _model("tinyllama-1.1b")
    single = InferenceServer(arch, params, ServeConfig(slots=4, context=64, transport=transport))
    reqs = [single.submit(p, max_new=m) for p, m in TRACE]
    single.run_until_idle()
    ref = [r.out_tokens for r in reqs]

    def run(churn):
        fleet = Fleet(arch, params, FleetConfig(workers=2, slots=4, context=64, transport=transport, max_workers=3))
        try:
            reqs = [fleet.submit(p, max_new=m) for p, m in TRACE]
            if churn:
                for _ in range(3):
                    fleet.step()  # decode underway on worker 0
                assert fleet.workers[0].core.active_slots()
                assert fleet.leave_worker(0) is True
                fleet.add_worker()
            fleet.run_until_idle()
            assert all(r.done_event.is_set() for r in reqs)
            if churn:
                assert fleet.handoffs >= 1 and (fleet.joins, fleet.leaves) == (1, 1)
            if transport == "shmem":
                assert fleet.group.stats.puts > 0
            return [r.out_tokens for r in reqs]
        finally:
            fleet.close()

    assert run(churn=True) == run(churn=False) == ref
