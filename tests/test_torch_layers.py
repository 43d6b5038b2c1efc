"""Port parity: ``repro_torch.models.layers`` against ``repro.models.layers``.

The same numpy inputs (seeded) go through the JAX function and its port;
both run in float32 on the CPU and must agree within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(1)
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(j, t, tol=TOL):
    err = float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))
    assert err <= tol, err


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 3, 16)])
def test_rms_norm_matches(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    _close(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), tl.rms_norm(_t(x), _t(w), 1e-5))


def test_rms_norm_computes_in_f32_and_casts_back():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 32)).astype(np.float32)
    w = np.ones(32, np.float32)
    out = tl.rms_norm(_t(x).bfloat16(), _t(w).bfloat16())
    assert out.dtype == torch.bfloat16
    ref = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    assert np.array_equal(np.asarray(ref, np.float32), out.float().numpy())


@pytest.mark.parametrize("pos_shape", ["seq", "batched"])
def test_apply_rope_matches(pos_shape):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    if pos_shape == "seq":
        pos = np.arange(7, dtype=np.int32) + 100
    else:  # decode: (B, 1) positions against a (B, 1, H, hd) input
        x = x[:, :1]
        pos = np.array([[3], [517]], np.int32)
    j = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    _close(j, tl.apply_rope(_t(x), _t(pos), 1e4), tol=1e-5)


def test_apply_rope_rotates_split_halves():
    # a unit vector on the first lane of the first half rotates into the
    # first lane of the SECOND half (not its interleaved neighbour)
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = tl.apply_rope(x, torch.tensor([1], dtype=torch.int32), 1e4)
    assert abs(float(out[..., 4]) - np.sin(1.0)) < 1e-6
    assert float(out[..., 1]) == 0.0


@pytest.mark.parametrize("gated", [True, False])
def test_ffn_apply_matches(gated):
    rng = np.random.default_rng(3)
    d, f = 32, 48
    p = {"w_up": rng.normal(size=(d, f)), "w_down": rng.normal(size=(f, d))}
    if gated:
        p["w_gate"] = rng.normal(size=(d, f))
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    j = jl.ffn_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), gated=gated)
    t = tl.ffn_apply({k: _t(v) for k, v in p.items()}, _t(x), gated=gated)
    _close(j, t, tol=1e-5)


def test_dense_init_is_a_truncated_fan_in_normal():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, (256, 64), torch.float32)
    scale = 1.0 / np.sqrt(256)
    assert w.shape == (256, 64) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * scale + 1e-7
    # std of a standard normal truncated to ±2 is 0.8796
    assert abs(float(w.std()) / scale - 0.8796) < 0.03
    again = tl.dense_init(torch.Generator().manual_seed(0), (256, 64), torch.float32)
    assert torch.equal(w, again)
    assert tl.embed_init(gen, 10, 4, torch.bfloat16).dtype == torch.bfloat16
