"""The plain references against the port's plain CPU path at the smoke
configurations, in float32: prefill, then decode through the cache."""
from __future__ import annotations

import pytest
import torch

from perfbench.tests.helpers import smoke_cfg

from perfbench.cells import arch_config, load_module
from perfbench.weights import make_params

TOL = 2e-4  # float32 on both sides: the port's attention sums in another order


def port_logits(params, cfg, prompt, served):
    """The port's logits at the positions that chose each served token:
    prefill of the prompt, then one decode step a served token."""
    from repro_torch.models import decode_step, init_cache, prefill

    arch = arch_config(cfg)
    cache = init_cache(arch, 1, 64, "cpu")
    with torch.inference_mode():
        logits, cache = prefill(params, arch, {"tokens": torch.tensor([prompt])}, cache)
        out = [logits[0, -1]]
        for i, tok in enumerate(served[:-1]):
            pos = torch.tensor([len(prompt) + i], dtype=torch.int32)
            logits, cache = decode_step(params, arch, torch.tensor([[tok]]), pos, cache)
            out.append(logits[0, 0])
    return torch.stack(out).float()


@pytest.mark.parametrize("name", ["deepseek-moe-16b"])
def test_reference_matches_port_plain_path(name):
    torch.manual_seed(0)
    cfg = smoke_cfg(name)
    params = make_params(cfg, 1234, "cpu")
    ref = load_module("reference", cfg["reference"])
    g = torch.Generator().manual_seed(5)
    reqs = []
    for plen, n in ((13, 9), (29, 4)):
        prompt = torch.randint(0, cfg["vocab_size"], (plen,), generator=g).tolist()
        served = torch.randint(0, cfg["vocab_size"], (n,), generator=g).tolist()
        reqs.append((prompt, served))
    got = ref.served_logits(params, cfg, reqs)
    for (prompt, served), r in zip(reqs, got):
        p = port_logits(params, cfg, prompt, served)
        assert r.shape == p.shape
        err = (r - p).abs().max().item() / r.abs().max().item()
        assert err < TOL, err
