"""MoE routing's queue positions on the card (``gpu``-marked; each skips
without a card).

* The positions of ``moe._positions`` on CUDA, from decode's 8 rows of 6
  slots to the longest prompt's 21,504 slots, equal the CPU's and the
  one-hot prefix sum's integer for integer, with a third of the slots
  crowded onto 3 experts, and read nothing back to the host.

Imports no jax: on a machine without JAX run it with ``--noconftest``."""
import pytest
import torch

from repro_torch.models import moe


def _one_hot_positions(e_idx, e):
    assign = (e_idx[..., None] == torch.arange(e, device=e_idx.device)).int()
    return ((torch.cumsum(assign, dim=1) - assign) * assign).sum(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(8, 6), (8, 48), (1, 9000), (1, 21504), (4, 21504)])
def test_cuda_positions_equal_the_cpu_ones(b, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(n)
    e_idx = torch.randint(0, 64, (b, n), generator=gen)
    e_idx[:, torch.rand(n, generator=gen) < 1 / 3] = torch.randint(0, 3, (1,), generator=gen)
    want = moe._positions(e_idx, 64)
    assert torch.equal(want, _one_hot_positions(e_idx, 64))
    ids = e_idx.cuda()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe._positions(ids, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert torch.equal(_one_hot_positions(ids, 64).cpu(), want)
