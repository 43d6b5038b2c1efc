"""Fused gradient quantize+pack: the Hopper kernel's wrapper, its plain
PyTorch version, and the tree-level pack around them.

The kernel (``csrc/grad_pack.cu``) replaces the Pallas TPU kernel
``_pack_kernel`` of ``repro/kernels/grad_pack.py``; see the source's header
for its design.  Leaves are flattened into one zero-padded f32 buffer of
:data:`TILE`-element tiles (``seg_ids`` maps each tile to its leaf), the
kernel computes

    error-feedback add  +  per-leaf int8 quantize  +  pack

and writes the ``KIND_Q8`` wire body ``[u32 offset table | f32 scales |
tile-padded int8 payload]`` in one device buffer, which reaches the host in
one device-to-host copy behind the header of :mod:`repro_torch.core.comm.
wire`.  The new error-feedback leaves stay on the device.

:func:`quantize_pack` picks the route by the tensors' device: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes
:func:`quantize_pack_plain`, the segment-max formulation of the
reference's ``_xla_pack``.  Parity contract: the wire bytes and the new EF
equal the host reference :func:`repro_torch.train.grad_sync.pack_grads_q8`
bit for bit on finite gradients, on either route.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core.comm import wire
from ..tree import leaves as tree_leaves
from ..tree import unflatten
from . import build
from .guard import refuse_autograd

__all__ = [
    "TILE",
    "quantize_pack",
    "quantize_pack_plain",
    "pack_grads_fused",
    "pack_grads_fused_plain",
    "unpack_grads_fused",
    "packed_nbytes",
]

TILE = wire.PACK_TILE

# The error-feedback update in every path (host numpy, plain, kernel):
#     r = g32 / scale;  q = clip(round(r), -127, 127);  ef = (r - q) * scale
# with the multiply last, and the scale as an explicit reciprocal multiply,
# so each op rounds once, identically, everywhere.
_RECIP127 = float(np.float32(1.0) / np.float32(127.0))


# ---------------------------------------------------------------------------
# The tile-level function: plain version and kernel
# ---------------------------------------------------------------------------


def _body_views(body: torch.Tensor, n_tiles: int, n_leaves: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scales (f32) and payload (int8, (n_tiles, TILE)) regions of a
    wire body."""
    scales = body[4 * n_leaves : 8 * n_leaves].view(torch.float32)
    payload = body[8 * n_leaves :].view(torch.int8).view(n_tiles, TILE)
    return scales, payload


def quantize_pack_plain(
    g_tiles: torch.Tensor,  # (n_tiles, TILE) f32
    ef_tiles: torch.Tensor,  # (n_tiles, TILE) f32
    seg_ids: torch.Tensor,  # (n_tiles,) int32, leaf of each tile
    n_leaves: int,
    body: torch.Tensor,  # uint8 (8 * n_leaves + n_tiles * TILE,)
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the reference's ``_xla_pack``):
    writes the scales and the payload into ``body`` and returns the new EF
    tiles (n_tiles, TILE) f32.  Leaves without a tile get maxabs 0."""
    seg = seg_ids.long()
    tiles = g_tiles + ef_tiles
    tile_max = tiles.abs().amax(dim=1)
    maxabs = torch.zeros(n_leaves, dtype=torch.float32, device=tiles.device)
    maxabs.scatter_reduce_(0, seg, tile_max, "amax", include_self=True)
    scale = torch.clamp_min(maxabs, 1e-12) * _RECIP127
    st = scale[seg][:, None]
    r = tiles / st
    q = torch.clamp(torch.round(r), -127, 127).to(torch.int8)
    ef_out = (r - q.float()) * st
    scales, payload = _body_views(body, g_tiles.shape[0], n_leaves)
    scales.copy_(scale)
    payload.copy_(q)
    return ef_out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("grad_pack")
    lib.repro_grad_pack.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.repro_grad_pack.restype = ctypes.c_int
    return lib


def _check(g_tiles: torch.Tensor, ef_tiles: torch.Tensor, seg_ids: torch.Tensor, n_leaves: int, body: torch.Tensor) -> None:
    ts = (g_tiles, ef_tiles, seg_ids, body)
    if not (g_tiles.is_cuda and all(t.device == g_tiles.device for t in ts)):
        raise ValueError(f"quantize_pack: inputs must lie on one CUDA device (got {[str(t.device) for t in ts]})")
    if g_tiles.dtype != torch.float32 or ef_tiles.dtype != torch.float32:
        raise TypeError(f"quantize_pack: g and ef tiles must be float32 (got {g_tiles.dtype}, {ef_tiles.dtype})")
    if seg_ids.dtype != torch.int32 or body.dtype != torch.uint8:
        raise TypeError(f"quantize_pack: seg_ids must be int32 and body uint8 (got {seg_ids.dtype}, {body.dtype})")
    n_tiles = g_tiles.shape[0]
    if g_tiles.dim() != 2 or g_tiles.shape[1] != TILE or ef_tiles.shape != g_tiles.shape or seg_ids.shape != (n_tiles,):
        raise ValueError(f"quantize_pack: want (n_tiles, {TILE}) tiles and (n_tiles,) seg_ids; got "
                         f"{tuple(g_tiles.shape)}, {tuple(ef_tiles.shape)}, {tuple(seg_ids.shape)}")
    if body.dim() != 1 or body.numel() != 8 * n_leaves + TILE * n_tiles:
        raise ValueError(f"quantize_pack: body holds {body.numel()} bytes, want {8 * n_leaves + TILE * n_tiles}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("quantize_pack: tiles, seg_ids and body must be contiguous")
    if not 0 < n_leaves < 2**31 or n_tiles >= 2**31:
        raise ValueError(f"quantize_pack: {n_leaves} leaves and {n_tiles} tiles exceed the kernel's range")


def quantize_pack(
    g_tiles: torch.Tensor,
    ef_tiles: torch.Tensor,
    seg_ids: torch.Tensor,
    n_leaves: int,
    body: torch.Tensor,
) -> torch.Tensor:
    """Fill ``body``'s scales and payload and return the new EF tiles, as
    :func:`quantize_pack_plain` does.  CUDA tensors run the kernel (two
    launches: the per-leaf max, then the quantize), CPU tensors the plain
    version.  ``quantize_pack.launches`` counts kernel calls."""
    if g_tiles.device.type == "cpu":
        return quantize_pack_plain(g_tiles, ef_tiles, seg_ids, n_leaves, body)
    _check(g_tiles, ef_tiles, seg_ids, n_leaves, body)
    refuse_autograd("quantize_pack", g_tiles, ef_tiles)
    ef_out = torch.empty_like(g_tiles)
    if g_tiles.shape[0] == 0:
        return ef_out
    maxabs = torch.empty(n_leaves, dtype=torch.int32, device=g_tiles.device)
    with torch.cuda.device(g_tiles.device):
        rc = _lib().repro_grad_pack(
            g_tiles.data_ptr(), ef_tiles.data_ptr(), seg_ids.data_ptr(), maxabs.data_ptr(), body.data_ptr(),
            ef_out.data_ptr(), g_tiles.shape[0], n_leaves, torch.cuda.current_stream(g_tiles.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"quantize_pack: kernel launch failed (CUDA error {rc})")
    quantize_pack.launches += 1
    return ef_out


quantize_pack.launches = 0


# ---------------------------------------------------------------------------
# Tree-level pack with a per-(structure, shapes, dtypes, device) plan cache
# ---------------------------------------------------------------------------


def _treedef(tree: Any) -> Any:
    """A hashable description of a tree's structure (leaves as '*')."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _treedef(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_treedef(v) for v in tree))
    return "*"


@dataclass
class _Plan:
    """What one tree layout needs: the header, the offset table (on the
    device), each leaf's start in the padded flat buffer, the tile-to-leaf
    map."""

    specs: List[wire.LeafSpec]
    header: bytes
    starts: List[int]
    n_tiles: int
    device: torch.device
    offs_dev: torch.Tensor  # uint8 (4 * n_leaves,)
    seg_dev: torch.Tensor  # int32 (n_tiles,)
    empty_body: bytes  # the whole body when n_tiles == 0

    def flatten(self, leaves: List[torch.Tensor], efs: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Leaves and EF leaves copied (as f32) into two zeroed flat
        buffers of (n_tiles, TILE): the zero fill is the tile padding of
        both, so padding bytes and maxima agree with the host's."""
        g_buf = torch.zeros(self.n_tiles * TILE, dtype=torch.float32, device=self.device)
        e_buf = torch.zeros(self.n_tiles * TILE, dtype=torch.float32, device=self.device)
        for s, start, g, e in zip(self.specs, self.starts, leaves, efs):
            if s.nelems:
                g_buf[start : start + s.nelems].copy_(g.detach().reshape(-1))
                e_buf[start : start + s.nelems].copy_(e.detach().reshape(-1))
        return g_buf.view(self.n_tiles, TILE), e_buf.view(self.n_tiles, TILE)


_CACHE: Dict[Any, _Plan] = {}


def _plan(tree: Any, leaves: List[torch.Tensor]) -> _Plan:
    devices = {t.device for t in leaves}
    if len(devices) > 1:
        raise ValueError(f"pack_grads_fused: the leaves lie on several devices: {sorted(map(str, devices))}")
    device = devices.pop() if devices else torch.device("cpu")
    key = (_treedef(tree), tuple((tuple(t.shape), t.dtype) for t in leaves), device)
    plan = _CACHE.get(key)
    if plan is None:
        plan = _CACHE[key] = _build(leaves, device)
    return plan


def _build(leaves: List[torch.Tensor], device: torch.device) -> _Plan:
    specs = [wire.leaf_spec(t, quantized=True) for t in leaves]
    n_leaves = len(specs)
    padded = [wire.padded_nelems(s.nelems) for s in specs]
    starts = np.cumsum([0] + padded[:-1]).tolist() if padded else []
    n_tiles = sum(padded) // TILE
    offs_bytes = struct.pack(f"<{n_leaves}I", *wire.q8_offsets(specs))
    seg = np.repeat(np.arange(n_leaves, dtype=np.int32), [p // TILE for p in padded])
    # every leaf empty (or no leaf): the scales follow the maxabs == 0 convention
    empty_scale = float(np.float32(np.float32(1e-12) * np.float32(_RECIP127)))
    return _Plan(
        specs=specs,
        header=wire.encode_grad_header(wire.KIND_Q8, specs),
        starts=starts,
        n_tiles=n_tiles,
        device=device,
        offs_dev=torch.tensor(list(offs_bytes), dtype=torch.uint8, device=device),
        seg_dev=torch.from_numpy(seg).to(device),
        empty_body=offs_bytes + struct.pack(f"<{n_leaves}f", *([empty_scale] * n_leaves)),
    )


def packed_nbytes(tree: Any) -> int:
    """Wire size of :func:`pack_grads_fused`'s output for ``tree``."""
    specs = [wire.leaf_spec(t, quantized=True) for t in tree_leaves(tree)]
    payload = sum(wire.padded_nelems(s.nelems) for s in specs)
    return wire.grad_header_bytes(specs) + 8 * len(specs) + payload


def _pack(tree: Any, ef: Any, quantize: Callable[..., torch.Tensor]) -> Tuple[bytes, Any]:
    leaves = tree_leaves(tree)
    plan = _plan(tree, leaves)
    n_leaves = len(plan.specs)
    if plan.n_tiles == 0:
        new_ef = [torch.zeros(s.shape, dtype=torch.float32, device=plan.device) for s in plan.specs]
        return plan.header + plan.empty_body, unflatten(tree, new_ef)
    g_tiles, ef_tiles = plan.flatten(leaves, tree_leaves(ef))
    body = torch.empty(8 * n_leaves + plan.n_tiles * TILE, dtype=torch.uint8, device=plan.device)
    body[: 4 * n_leaves].copy_(plan.offs_dev)
    ef_out = quantize(g_tiles, ef_tiles, plan.seg_dev, n_leaves, body)
    del g_tiles, ef_tiles
    # the one device-to-host copy, into page-locked memory when it comes
    # from a card (a pageable copy of a 1 GB wire runs at ~2 GB/s)
    host = torch.empty(body.shape, dtype=torch.uint8, pin_memory=body.is_cuda)
    host.copy_(body)
    data = b"".join([plan.header, memoryview(host.numpy())])
    ef_flat = ef_out.view(-1)
    new_ef = [ef_flat[start : start + s.nelems].view(s.shape) for s, start in zip(plan.specs, plan.starts)]
    return data, unflatten(tree, new_ef)


def pack_grads_fused(tree: Any, ef: Any) -> Tuple[bytes, Any]:
    """Fused pack of a gradient tree on its device: returns ``(wire_bytes,
    new_ef_tree)`` with wire bytes bit-identical to
    :func:`repro_torch.train.grad_sync.pack_grads_q8` and the new EF leaves
    (f32) left on the device.  CUDA leaves run the kernel, CPU leaves the
    plain version."""
    return _pack(tree, ef, quantize_pack)


def pack_grads_fused_plain(tree: Any, ef: Any) -> Tuple[bytes, Any]:
    """:func:`pack_grads_fused` through the plain version on any device:
    what the kernel is held against on the card."""
    return _pack(tree, ef, quantize_pack_plain)


def _readonly_bytes(buf: memoryview, offset: int, count: int) -> torch.Tensor:
    """A uint8 tensor over ``count`` bytes of ``buf`` without a copy; the
    caller only reads it (torch warns that the buffer is not writable)."""
    if count == 0:
        return torch.empty(0, dtype=torch.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(buf, dtype=torch.uint8, count=count, offset=offset)


def unpack_grads_fused(data, like: Any) -> Any:
    """Rebuild the dequantized (f32) gradient tree from ``KIND_Q8`` wire
    bytes — the receiver-side twin of :func:`pack_grads_fused`.  The
    payload moves to the device of ``like``'s leaves in one copy and is
    dequantized there (``q * scale`` in f32, bit for bit the host's)."""
    buf = memoryview(data)
    kind, specs, off = wire.parse_grad_header(buf)
    if kind != wire.KIND_Q8:
        raise ValueError(f"expected KIND_Q8 wire payload, got kind {kind}")
    like_leaves = tree_leaves(like)
    device = like_leaves[0].device if like_leaves and isinstance(like_leaves[0], torch.Tensor) else torch.device("cpu")
    n = len(specs)
    off += 4 * n
    scales = torch.from_numpy(np.frombuffer(buf, dtype=np.float32, count=n, offset=off).copy()).to(device)
    off += 4 * n
    total = sum(wire.padded_nelems(s.nelems) for s in specs)
    payload = _readonly_bytes(buf, off, total).to(device).view(torch.int8)
    leaves, cur = [], 0
    for i, s in enumerate(specs):
        q = payload[cur : cur + s.nelems]
        leaves.append((q.float() * scales[i]).reshape(s.shape))
        cur += wire.padded_nelems(s.nelems)
    return unflatten(like, leaves)
