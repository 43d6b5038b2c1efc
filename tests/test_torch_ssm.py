"""Port parity: the SSD kernel's plain version and the Mamba2 block.

* ``ssd_chunk_plain`` against the JAX Pallas kernel run in interpret mode
  and against the sequential oracle ``ssd_chunk_ref`` (the JAX one and the
  port's copy), on the reference's ``SSD_CASES`` within 1e-4;
* ``ssd_chunked`` (a ragged S included), ``ssm_apply`` and ``ssm_decode``
  against the JAX module in its CPU default (xla) mode, on bridged f32
  inputs within 1e-4;
* the kernel route's views and casts against the plain route;
* the roundings of the CUDA kernel's bf16 (tensor-core) route, emulated
  in f32 here, against the Pallas kernel at mamba2-130m's widths.

The CUDA kernel's own check against its plain version is ``gpu``-marked
in ``tests/test_torch_port_rules.py``, which imports no JAX.  Inputs are
made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.kernels.ref import ssd_chunk_ref as j_ssd_ref
from repro.kernels.ssd_scan import ssd_chunk_kernel as j_ssd_kernel
from repro.models import ssm as jssm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SMOKES
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_chunk_kernel, ssd_chunk_plain, ssd_chunk_ref
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)
TOL = 1e-4

SSD_CASES = [
    # (B, H, G, nc, Q, P, N): tests/test_kernels.py
    (2, 4, 2, 3, 64, 64, 128),
    (1, 2, 1, 2, 128, 64, 64),
    (1, 8, 8, 1, 64, 32, 128),
    (2, 2, 1, 4, 32, 64, 32),
]


def _chunk_inputs(case, seed=0):
    """The reference test's scales: a_dt = -|N|·0.1, x ~ N, b/c ~ 0.3·N."""
    B, H, G, NC, Q, P, N = case
    rng = np.random.default_rng(seed + sum(case))
    a = (-np.abs(rng.normal(size=(B, H, NC, Q))) * 0.1).astype(np.float32)
    x = rng.normal(size=(B, H, NC, Q, P)).astype(np.float32)
    b = (rng.normal(size=(B, G, NC, Q, N)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(B, G, NC, Q, N)) * 0.3).astype(np.float32)
    return a, x, b, c


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunk_plain_matches_the_pallas_kernel(case):
    a, x, b, c = _chunk_inputs(case)
    jy, js = j_ssd_kernel(*(jnp.asarray(v) for v in (a, x, b, c)), interpret=True)
    ty, ts = ssd_chunk_plain(*_t(a, x, b, c))
    assert ty.dtype == torch.float32 and ts.dtype == torch.float32
    assert tuple(ty.shape) == jy.shape and tuple(ts.shape) == js.shape
    assert _err(jy, ty) <= TOL
    assert _err(js, ts) <= TOL


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunk_plain_matches_the_sequential_oracle(case):
    B, H, G, NC, Q, P, N = case
    a, x, b, c = _chunk_inputs(case, seed=1)
    rep = H // G
    # every (batch, chunk) as one row of the oracle: (B·nc, Q, H, ·)
    xo = x.transpose(0, 2, 3, 1, 4).reshape(B * NC, Q, H, P)
    ao = a.transpose(0, 2, 3, 1).reshape(B * NC, Q, H)
    bo = np.repeat(b, rep, axis=1).transpose(0, 2, 3, 1, 4).reshape(B * NC, Q, H, N)
    co = np.repeat(c, rep, axis=1).transpose(0, 2, 3, 1, 4).reshape(B * NC, Q, H, N)
    jy, js = j_ssd_ref(*(jnp.asarray(v) for v in (xo, ao, bo, co)))
    ry, rs = ssd_chunk_ref(*_t(xo, ao, bo, co))
    assert _err(jy, ry) <= 1e-5 and _err(js, rs) <= 1e-5  # the copy is the oracle
    ty, ts = ssd_chunk_plain(*_t(a, x, b, c))
    ty = ty.permute(0, 2, 3, 1, 4).reshape(B * NC, Q, H, P)
    ts = ts.permute(0, 2, 1, 3, 4).reshape(B * NC, H, P, N)
    assert float((ty - ry).abs().max()) <= TOL
    assert float((ts - rs).abs().max()) <= TOL


def test_ssd_chunk_kernel_takes_the_plain_route_on_the_cpu():
    a, x, b, c = _t(*_chunk_inputs(SSD_CASES[3]))
    before = ssd_chunk_kernel.launches
    ky, ks = ssd_chunk_kernel(a, x, b, c)
    py, ps = ssd_chunk_plain(a, x, b, c)
    assert ssd_chunk_kernel.launches == before  # counts kernel launches only
    assert torch.equal(ky, py) and torch.equal(ks, ps)
    oy, os_ = ops.ssd_chunk(a, x, b, c)
    assert torch.equal(oy, py) and torch.equal(os_, ps)


def test_ssd_chunk_rejects_bad_inputs():
    a, x, b, c = _t(*_chunk_inputs(SSD_CASES[0]))  # H=4, G=2
    with pytest.raises(ValueError):
        ssd_chunk_kernel(a, x[:, :, :, :-1], b, c)  # Q disagrees
    with pytest.raises(ValueError):
        ssd_chunk_kernel(a[:, :3], x[:, :3], b, c)  # 3 heads over 2 groups
    with pytest.raises(ValueError):
        ssd_chunk_kernel(a, x, b, c[..., :-1])  # b and c disagree
    with pytest.raises(TypeError):
        ssd_chunk_kernel(a, x, b.double(), c)


def _split_bf16(v):
    """v = hi + lo, each a bf16 value: hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _tensor_core_route(a, x, b, c, split_state=True):
    """The bf16 route of ``csrc/ssd_scan.cu`` as it rounds, in f32 on the
    CPU: S = C·Bᵀ in f32 (bf16 operands, so every product is exact); S ⊙ L
    split hi + lo, each term times X summed in f32; the decay-weighted X
    split hi + lo, each term times B summed in f32; y rounded to bf16 once.
    ``split_state=False`` rounds the decay-weighted X to bf16 once."""
    h, g = x.shape[1], b.shape[1]
    xf = x.float()
    bf = b.float().repeat_interleave(h // g, dim=1)
    cf = c.float().repeat_interleave(h // g, dim=1)
    acs = torch.cumsum(a, dim=-1)
    q = a.shape[-1]
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    L = torch.where(causal, torch.exp(acs[..., :, None] - acs[..., None, :]), torch.zeros(()))
    hi, lo = _split_bf16(torch.einsum("bhcin,bhcjn->bhcij", cf, bf) * L)
    y = (hi @ xf + lo @ xf).to(x.dtype)
    w = xf * torch.exp(acs[..., -1:] - acs)[..., None]
    if not split_state:
        return y, w.to(torch.bfloat16).float().transpose(-1, -2) @ bf
    hi, lo = _split_bf16(w)
    return y, hi.transpose(-1, -2) @ bf + lo.transpose(-1, -2) @ bf


def test_tensor_core_route_roundings_hold_the_tolerances():
    """At mamba2-130m's widths (H=24, G=1, Q=64, P=64, N=128; 2 chunks)
    in bf16, the tensor-core route's roundings stay within the card's
    tolerances of the Pallas kernel (interpret mode): y within 2^-7 of
    max |y|, the f32 states within 1e-4 of max(1, max |state|).  One bf16
    rounding of the decay-weighted X instead of the hi + lo split breaks
    the states' tolerance: the reason for the split."""
    a, x, b, c = _chunk_inputs((1, 24, 1, 2, 64, 64, 128))
    jy, js = j_ssd_kernel(jnp.asarray(a), *(jnp.asarray(v).astype(jnp.bfloat16) for v in (x, b, c)), interpret=True)
    jy, js = np.asarray(jy.astype(jnp.float32)), np.asarray(js)
    at = torch.from_numpy(a)
    xt, bt, ct = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, b, c))
    y_tol = 2.0**-7 * np.abs(jy).max()
    s_tol = 1e-4 * max(1.0, np.abs(js).max())
    ty, ts = _tensor_core_route(at, xt, bt, ct)
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    assert _err(jy, ty) <= y_tol
    assert _err(js, ts) <= s_tol
    _, ts_once = _tensor_core_route(at, xt, bt, ct, split_state=False)
    assert _err(js, ts_once) > s_tol


def _seq_inputs(bsz, s, h, g, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    a_dt = (-np.abs(rng.normal(size=(bsz, s, h))) * 0.1).astype(np.float32)
    b = (rng.normal(size=(bsz, s, g, n)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(bsz, s, g, n)) * 0.3).astype(np.float32)
    return x, a_dt, b, c


@pytest.mark.parametrize("s, with_state", [(64, False), (61, False), (37, True)])
def test_ssd_chunked_matches_jax(s, with_state, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")
    bsz, h, g, p, n, q = 2, 4, 2, 16, 32, 16
    x, a_dt, b, c = _seq_inputs(bsz, s, h, g, p, n, seed=s)
    init = np.random.default_rng(5).normal(size=(bsz, h, p, n)).astype(np.float32) if with_state else None
    jy, js = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, a_dt, b, c)), q,
                              init_state=None if init is None else jnp.asarray(init))
    ty, ts = tssm.ssd_chunked(*_t(x, a_dt, b, c), q, init_state=None if init is None else torch.from_numpy(init))
    assert tuple(ty.shape) == (bsz, s, h, p)
    assert _err(jy, ty) <= TOL
    assert _err(js, ts) <= TOL


@pytest.mark.parametrize("s", [64, 61])
def test_kernel_route_layout_matches_the_plain_route(s, monkeypatch):
    """The CUDA branch's views and casts (the reference's Pallas branch),
    fed to the kernel's plain version on the CPU, give the plain branch's
    blocks, and the JAX Pallas branch (interpret mode) the same output."""
    bsz, h, g, p, n, q = 1, 4, 1, 16, 32, 16
    x, a_dt, b, c = _seq_inputs(bsz, s, h, g, p, n, seed=3)
    pad = -s % q
    xp, ap, bp, cp = (np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2)) for v in (x, a_dt, b, c))
    xt, at, bt, ct = _t(xp, ap, bp, cp)
    nc = (s + pad) // q
    xc = xt.reshape(bsz, nc, q, h, p)
    ac = at.reshape(bsz, nc, q, h)
    cc = ct.reshape(bsz, nc, q, g, n).repeat_interleave(h // g, dim=3)
    ky, ks = tssm._chunk_blocks_kernel(xc, ac, bt, ct, bsz, nc, q, g, n)
    py, ps = tssm._chunk_blocks_plain(xc, ac, torch.cumsum(ac, dim=2), bt, cc, bsz, nc, q, g, n, h // g)
    assert ky.shape == py.shape and ks.shape == ps.shape
    assert float((ky - py).abs().max()) <= 1e-5 and float((ks - ps).abs().max()) <= 1e-5
    monkeypatch.setenv("REPRO_KERNELS", "pallas-interpret")
    jy, js = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, a_dt, b, c)), q)
    ty, ts = tssm.ssd_chunked(*_t(x, a_dt, b, c), q)
    assert _err(jy, ty) <= TOL and _err(js, ts) <= TOL


@pytest.fixture(scope="module", params=["mamba2-130m", "zamba2-1.2b"])
def block(request):
    name = request.param
    jcfg = J_SMOKES[name].variant(dtype="float32")
    jp = jssm.ssm_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, SMOKES[name].variant(dtype="float32"), jp, tp


@pytest.mark.parametrize("s", [13, 32])
def test_ssm_apply_matches_jax(block, s, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")
    jcfg, tcfg, jp, tp = block
    u = np.random.default_rng(s).normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jstate = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    jo, jst = jssm.ssm_apply(jp, jnp.asarray(u), jcfg, state=jstate)
    tstate = tssm.init_ssm_cache(tcfg, 2, torch.float32, torch.device("cpu"))
    to, tst = tssm.ssm_apply(tp, torch.from_numpy(u), tcfg, state=tstate)
    assert tst is tstate  # filled in place
    assert _err(jo, to) <= TOL
    assert _err(jst["ssm"], tst["ssm"]) <= TOL
    assert _err(jst["conv"], tst["conv"]) <= TOL


def test_ssm_decode_matches_jax(block):
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(11)
    tstate = tssm.init_ssm_cache(tcfg, 3, torch.float32, torch.device("cpu"))
    ssm0 = rng.normal(size=tuple(tstate["ssm"].shape)).astype(np.float32)
    conv0 = rng.normal(size=tuple(tstate["conv"].shape)).astype(np.float32)
    tstate["ssm"].copy_(torch.from_numpy(ssm0))
    tstate["conv"].copy_(torch.from_numpy(conv0))
    jstate = {"ssm": jnp.asarray(ssm0), "conv": jnp.asarray(conv0)}
    for step in range(3):
        u = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
        jo, jstate = jssm.ssm_decode(jp, jnp.asarray(u), jcfg, jstate)
        to, tst = tssm.ssm_decode(tp, torch.from_numpy(u), tcfg, tstate)
        assert tst is tstate
        assert _err(jo, to) <= TOL, step
        assert _err(jstate["ssm"], tstate["ssm"]) <= TOL, step
        assert _err(jstate["conv"], tstate["conv"]) <= TOL, step


def test_ssm_params_keep_their_f32_leaves_in_a_bf16_model():
    cfg = SMOKES["mamba2-130m"]
    assert cfg.dtype == "bfloat16"
    p = tssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    jshape = jax.eval_shape(lambda: jssm.ssm_init(jax.random.PRNGKey(0), J_SMOKES["mamba2-130m"], jnp.bfloat16))
    for name, leaf in p.items():
        assert tuple(leaf.shape) == jshape[name].shape, name
        assert str(leaf.dtype).replace("torch.", "") == str(jshape[name].dtype), name
    assert {k for k, v in p.items() if v.dtype == torch.float32} == {"A_log", "D", "dt_bias"}
