"""Mamba2 SSD intra-chunk block: the Hopper kernel's wrapper, its plain
PyTorch version and the sequential oracle.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``_ssd_kernel`` of ``repro/kernels/ssd_scan.py``; see the source's header
for its design.  Per (batch, head, chunk) it computes the causal
intra-chunk output ``y_diag = ((C·Bᵀ) ⊙ L) · X`` and the chunk's state
``Xᵀ · (B ⊙ exp(acs_last − acs))``, with B/C groups resolved by index
(head ``h`` reads group ``h // (H/G)``).  :func:`ssd_chunk_kernel` picks
the route by the tensors' device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes :func:`ssd_chunk_plain`.  In the kernel, bf16
runs on the tensor cores, one block for several heads of a group
(:func:`heads_per_block`), and f32 on the SIMT code.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import build
from .guard import refuse_autograd

__all__ = ["ssd_chunk_plain", "ssd_chunk_ref", "ssd_chunk_kernel", "smem_bytes", "heads_per_block", "DTYPES",
           "MAX_SMEM_BYTES"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448  # what one block may opt in to on Hopper (227 KB)
TC_WARPS, Y_COLS, TC_PAD = 4, 32, 8  # the bf16 route's warps, y columns a warp item covers, row padding


def ssd_chunk_plain(
    a_dt: torch.Tensor,  # (B, H, nc, Q)
    x: torch.Tensor,  # (B, H, nc, Q, P)
    b: torch.Tensor,  # (B, G, nc, Q, N)
    c: torch.Tensor,  # (B, G, nc, Q, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same signature, layout and
    output dtypes, all arithmetic in f32.  Returns (y_diag (B,H,nc,Q,P) in
    x's dtype, chunk states (B,H,nc,P,N) in f32)."""
    _check_shapes(a_dt, x, b, c)
    h, q = a_dt.shape[1], a_dt.shape[3]
    rep = h // b.shape[1]
    xf = x.float()
    bf = b.float().repeat_interleave(rep, dim=1)  # (B,H,nc,Q,N)
    cf = c.float().repeat_interleave(rep, dim=1)
    acs = torch.cumsum(a_dt.float(), dim=-1)  # (B,H,nc,Q)
    diff = acs[..., :, None] - acs[..., None, :]
    causal = torch.ones((q, q), dtype=torch.bool, device=a_dt.device).tril()
    L = torch.where(causal, torch.exp(diff), torch.zeros((), device=a_dt.device))
    g = torch.einsum("bhcin,bhcjn->bhcij", cf, bf)
    y = torch.einsum("bhcij,bhcjp->bhcip", g * L, xf)
    decay = torch.exp(acs[..., -1:] - acs)  # (B,H,nc,Q)
    states = torch.einsum("bhcqp,bhcqn->bhcpn", xf, bf * decay[..., None])
    return y.to(x.dtype), states


def ssd_chunk_ref(
    x: torch.Tensor,  # (B, Q, H, P) pre-discretized (x·dt), one chunk
    a_dt: torch.Tensor,  # (B, Q, H)
    b: torch.Tensor,  # (B, Q, H, N) groups pre-broadcast
    c: torch.Tensor,  # (B, Q, H, N)
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy of ``repro.kernels.ref.ssd_chunk_ref``, the sequential
    (recurrent) oracle for one SSD chunk:
    s_t = exp(a_t)·s_{t-1} + b_t ⊗ x_t ;  y_t = s_t · c_t."""
    bsz, q, h, p = x.shape
    n = b.shape[-1]
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) if init_state is None else init_state.float()
    ys = []
    for t in range(q):
        xt, at, bt, ct = x[:, t].float(), a_dt[:, t].float(), b[:, t].float(), c[:, t].float()
        s = torch.exp(at)[..., None, None] * s + xt[..., None] * bt[:, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", s, ct))
    return torch.stack(ys, dim=1).to(x.dtype), s


def _check_shapes(a_dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> None:
    if a_dt.dim() != 4 or x.dim() != 5 or b.dim() != 5 or b.shape != c.shape:
        raise ValueError(
            f"ssd_chunk: want a_dt (B,H,nc,Q), x (B,H,nc,Q,P), b and c (B,G,nc,Q,N); got "
            f"{tuple(a_dt.shape)}, {tuple(x.shape)}, {tuple(b.shape)}, {tuple(c.shape)}"
        )
    bsz, h, nc, q = a_dt.shape
    if tuple(x.shape[:4]) != (bsz, h, nc, q) or (b.shape[0], b.shape[2], b.shape[3]) != (bsz, nc, q):
        raise ValueError(f"ssd_chunk: a_dt {tuple(a_dt.shape)}, x {tuple(x.shape)} and b {tuple(b.shape)} disagree")
    if b.shape[1] == 0 or h % b.shape[1]:
        raise ValueError(f"ssd_chunk: {h} heads are not a multiple of {b.shape[1]} groups")
    if not (a_dt.is_floating_point() and x.dtype == b.dtype == c.dtype and x.is_floating_point()):
        raise TypeError(f"ssd_chunk: dtypes {a_dt.dtype}, {x.dtype}, {b.dtype}, {c.dtype}")


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def smem_bytes(q: int, p: int, n: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block needs at (Q, P, N), as the C side
    counts it.  f32 (``smem_floats``): acs (Q), b and c transposed
    (N x (Q+4) each), x (Q x P) and the Q x (Q+4) product, f32.  bf16
    (``tc_layout``), with Q, P, N rounded up to 16: the causal 16 x 16 tiles
    of S in f32, C and B (Q x (N+8) bf16 each), two X buffers (Q x (P+8)),
    each warp's 16 x 40 y staging tile, and acs and the decay (2 x Q f32
    each)."""
    if dtype == torch.float32:
        return 4 * (q + 2 * n * (q + 4) + q * p + q * (q + 4))
    qp, pp, np_ = _round16(q), _round16(p), _round16(n)
    t = qp // 16
    return (t * (t + 1) // 2 * 1024 + 2 * 2 * qp * (np_ + TC_PAD) + 2 * 2 * qp * (pp + TC_PAD)
            + 2 * TC_WARPS * 16 * (Y_COLS + TC_PAD) + 16 * qp)


def heads_per_block(cells: int, group_heads: int, slots: int) -> int:
    """Heads of one group that a bf16 block takes: the fewest that fit the
    ``cells`` (batch, head, chunk) cells into one wave of ``slots`` blocks
    (SMs × blocks an SM holds), at least 1 and at most the group's
    ``group_heads``.  S = C·Bᵀ is then computed once a block for all its
    heads, while the grid still fills the card."""
    return max(1, min(group_heads, -(-cells // slots)))


def _check_kernel(a_dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> int:
    """Raises on what the kernel cannot take; returns its shared-memory bytes."""
    if not (x.is_cuda and all(t.device == x.device for t in (a_dt, b, c))):
        raise ValueError(f"ssd_chunk_kernel: inputs must lie on one CUDA device (got {a_dt.device}, {x.device}, {b.device}, {c.device})")
    if a_dt.dtype != torch.float32 or x.dtype not in DTYPES:
        raise TypeError(f"ssd_chunk_kernel: a_dt must be float32 and x, b, c float32 or bfloat16 (got {a_dt.dtype}, {x.dtype})")
    bsz, h, nc, q = a_dt.shape
    p, n = x.shape[-1], b.shape[-1]
    if any(d % 4 for d in (q, p, n)) or q > 128:
        raise ValueError(f"ssd_chunk_kernel: Q={q}, P={p}, N={n} must be multiples of 4, with Q <= 128")
    if any(t.stride(-1) != 1 for t in (x, b, c)):
        raise ValueError("ssd_chunk_kernel: the last dim of x, b and c must be contiguous")
    if max(h, bsz) > 65535 or nc > 2**31 - 1:
        raise ValueError(f"ssd_chunk_kernel: {bsz} batches x {h} heads x {nc} chunks exceed the launch grid")
    smem = smem_bytes(q, p, n, x.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_chunk_kernel: Q={q}, P={p}, N={n} need {smem} bytes of shared memory (> {MAX_SMEM_BYTES})")
    return smem


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("ssd_scan")
    lib.repro_ssd_chunk_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 16 + [ctypes.c_void_p]
    )
    lib.repro_ssd_chunk_fwd.restype = ctypes.c_int
    lib.repro_ssd_chunk_opt_in.argtypes = [ctypes.c_int] * 2
    lib.repro_ssd_chunk_opt_in.restype = ctypes.c_int
    lib.repro_ssd_chunk_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.repro_ssd_chunk_blocks_per_sm.restype = ctypes.c_int
    lib.repro_ssd_chunk_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.repro_ssd_chunk_smem_bytes.restype = ctypes.c_longlong
    return lib


_opted_in: Dict[Tuple[int, int], int] = {}  # (device, dtype code) -> bytes opted in to
_slots: Dict[Tuple[int, int, int], int] = {}  # (device, dtype code, bytes) -> blocks the card holds at once


def _opt_in(device: torch.device, dtype: int, smem: int) -> None:
    """Raise the kernel's shared-memory limit on ``device`` to ``smem``
    bytes, once per larger size."""
    key = (device.index, dtype)
    if _opted_in.get(key, 0) >= smem:
        return
    rc = _lib().repro_ssd_chunk_opt_in(dtype, smem)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_kernel: opting in to {smem} bytes of shared memory failed (CUDA error {rc})")
    _opted_in[key] = smem


def _wave_slots(device: torch.device, dtype: int, smem: int) -> int:
    """Blocks of the ``dtype`` route that ``device`` holds at once with
    ``smem`` bytes of shared memory each: SMs × blocks an SM holds."""
    key = (device.index, dtype, smem)
    if key not in _slots:
        per_sm = _lib().repro_ssd_chunk_blocks_per_sm(dtype, smem)
        if per_sm <= 0:
            raise RuntimeError(f"ssd_chunk_kernel: no block fits an SM at {smem} bytes of shared memory ({per_sm})")
        _slots[key] = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    return _slots[key]


def ssd_chunk_kernel(
    a_dt: torch.Tensor,  # (B, H, nc, Q) A·dt per step
    x: torch.Tensor,  # (B, H, nc, Q, P) pre-discretized inputs (x·dt)
    b: torch.Tensor,  # (B, G, nc, Q, N)
    c: torch.Tensor,  # (B, G, nc, Q, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y_diag (B,H,nc,Q,P) in x's dtype, chunk_states
    (B,H,nc,P,N) in f32).  CUDA tensors run the kernel (read through their
    strides), CPU and meta tensors :func:`ssd_chunk_plain`.
    ``ssd_chunk_kernel.launches`` counts kernel launches;
    ``ssd_chunk_kernel.heads_per_block`` is the last launch's heads a
    block."""
    if x.device.type in ("cpu", "meta"):  # meta: the dry-run's shapes, no data
        return ssd_chunk_plain(a_dt, x, b, c)
    _check_shapes(a_dt, x, b, c)
    smem = _check_kernel(a_dt, x, b, c)
    refuse_autograd("ssd_chunk_kernel", a_dt, x, b, c)
    bsz, h, nc, q = a_dt.shape
    p, g, n = x.shape[-1], b.shape[1], b.shape[-1]
    y = torch.empty((bsz, h, nc, q, p), dtype=x.dtype, device=x.device)
    states = torch.empty((bsz, h, nc, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or states.numel() == 0:
        return y, states
    code = DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        _opt_in(x.device, code, smem)
        hpb = heads_per_block(bsz * h * nc, h // g, _wave_slots(x.device, code, smem)) if code == 1 else 1
        rc = _lib().repro_ssd_chunk_fwd(
            a_dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(), states.data_ptr(),
            code, bsz, h, g, nc, q, p, n, hpb,
            *a_dt.stride(), *x.stride()[:4], *b.stride()[:4], *c.stride()[:4],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_kernel: kernel launch failed (CUDA error {rc})")
    ssd_chunk_kernel.launches += 1
    ssd_chunk_kernel.heads_per_block = hpb
    return y, states


ssd_chunk_kernel.launches = 0
ssd_chunk_kernel.heads_per_block = 0
