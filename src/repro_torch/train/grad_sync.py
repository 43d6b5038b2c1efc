"""Gradient compression with error feedback, and the gradient wire.

Port of ``repro/train/grad_sync.py``.  int8 per-tensor quantization with
an error-feedback accumulator: the quantization residual is carried to the
next step, so compression is unbiased in the long run.

The host-side gradient-sync hand-off rides the port's comm layer:
:func:`pack_grads` / :func:`unpack_grads` turn a gradient tree into wire
bytes and back, so data-parallel ranks exchange compressed gradients
through :class:`~repro_torch.core.comm.collective.CommChannel` verbs.  Two
body kinds share the header of :mod:`repro_torch.core.comm.wire`:

* ``KIND_RAW`` — leaf bytes concatenated tightly in leaf order
  (:func:`pack_grads`); int8 leaves stay int8, bf16 leaves travel as their
  16-bit patterns.
* ``KIND_Q8`` — the quantized wire: offset table + per-tensor scales +
  tile-padded int8 payload (:func:`pack_grads_q8`).  This numpy host path
  is the byte-exact reference for the device kernel in
  :mod:`repro_torch.kernels.grad_pack`.

Trees are nested dicts, lists and tuples of tensors, flattened in
``jax.tree.leaves`` order (:mod:`repro_torch.tree`), so the wire bytes
equal the reference's for the same tree.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from ..core.comm import wire
from ..tree import leaves as tree_leaves
from ..tree import unflatten

__all__ = [
    "compress_grads_int8_ef",
    "pack_grads",
    "unpack_grads",
    "pack_grads_q8",
    "make_packer",
]

_F32_EPS = np.float32(1e-12)
# Reciprocal multiply, NOT division, in the packed wire's scale: the
# reference's jit backends strength-reduce division by a constant into
# ``x * (1/127)``, which differs from IEEE division by 1 ulp for some
# inputs, so every pack path (host, plain, kernel) multiplies.
_F32_RECIP127 = np.float32(1.0) / np.float32(127.0)


def _q(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # the reference divides here (``/ 127.0``), unlike the packed wire
    scale = torch.clamp_min(g.abs().amax(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads_int8_ef(grads: Any, ef: Any) -> Tuple[Any, Any]:
    """Returns (dequantized f32 grads, new error-feedback state), each a
    tree of ``grads``' structure."""
    deq, new_ef = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(ef)):
        g32 = g.float() + e
        q, scale = _q(g32)
        d = q.float() * scale
        deq.append(d)
        new_ef.append(g32 - d)
    return unflatten(grads, deq), unflatten(grads, new_ef)


def _host_leaf(t: torch.Tensor) -> torch.Tensor:
    """A leaf on the host, contiguous, without a copy when it already is."""
    return t.detach().cpu().contiguous()


def _host_f32(t: torch.Tensor) -> np.ndarray:
    """A leaf as a host f32 array (bf16 and the other types widen
    exactly, as ``astype(np.float32)`` does in the reference)."""
    h = _host_leaf(t)
    return (h if h.dtype == torch.float32 else h.float()).numpy()


def _leaf_bytes(t: torch.Tensor) -> memoryview:
    """A host leaf's bytes as a view (bf16 as its 16-bit patterns)."""
    return _host_leaf(t).reshape(-1).view(torch.uint8).numpy().data


def pack_grads(tree: Any) -> bytes:
    """Serialize a gradient tree's leaves to ``KIND_RAW`` wire bytes for
    the host-side DP hand-off.  Structure travels out of band (both ranks
    hold the same model), so the wire carries only the leaves; contiguous
    host leaves are joined as views, not copies."""
    arrs = [_host_leaf(leaf) for leaf in tree_leaves(tree)]
    specs = [wire.leaf_spec(a) for a in arrs]
    parts: List[Any] = [wire.encode_grad_header(wire.KIND_RAW, specs)]
    for a in arrs:
        if a.numel():
            parts.append(_leaf_bytes(a))
    return b"".join(parts)


def _like_device(leaf: Any) -> torch.device:
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")


def unpack_grads(data, like: Any) -> Any:
    """Rebuild a gradient tree from wire bytes using the receiver's own
    structure (``like``), each leaf on the device of ``like``'s leaf.
    ``KIND_RAW`` restores the original dtypes; ``KIND_Q8`` dequantizes to
    f32 leaves (``compress_grads_int8_ef``'s output dtype), on the host in
    numpy as the reference does."""
    buf = memoryview(data)
    kind, specs, off = wire.parse_grad_header(buf)
    devices = [_like_device(leaf) for leaf in tree_leaves(like)]
    leaves: List[torch.Tensor] = []
    if kind == wire.KIND_RAW:
        for s, dev in zip(specs, devices):
            if s.nbytes == 0:
                leaves.append(torch.empty(s.shape, dtype=s.dtype, device=dev))
                continue
            raw = np.frombuffer(buf, dtype=np.uint8, count=s.nbytes, offset=off).copy()
            leaves.append(torch.from_numpy(raw).view(s.dtype).reshape(s.shape).to(dev))
            off += s.nbytes
    elif kind == wire.KIND_Q8:
        n = len(specs)
        off += 4 * n  # offset table (recomputable from specs; skipped)
        scales = np.frombuffer(buf, dtype=np.float32, count=n, offset=off)
        off += 4 * n
        for s, scale, dev in zip(specs, scales, devices):
            q = np.frombuffer(buf, dtype=np.int8, count=s.nelems, offset=off)
            deq = q.astype(np.float32) * scale
            leaves.append(torch.from_numpy(deq.reshape(s.shape)).to(dev))
            off += wire.padded_nelems(s.nelems)
    else:
        raise ValueError(f"unknown gradient wire kind {kind}")
    return unflatten(like, leaves)


def _q8_host(g32: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.float32]:
    """Host-reference int8 quantize — the same f32 ops, in the same order,
    as the device kernel, so the bytes are bit-comparable (max reductions
    are exact; elementwise f32 add/div/round are IEEE; numpy and the
    kernel both round half-to-even).  The error feedback is
    ``(r - q) * scale`` with the multiply LAST — the ``g32 - q*scale`` form
    lets a compiler contract multiply+subtract into a single-rounding fma
    that numpy's two-rounding sequence cannot reproduce bitwise."""
    maxabs = np.max(np.abs(g32)) if g32.size else np.float32(0.0)
    scale = np.float32(np.maximum(maxabs, _F32_EPS) * _F32_RECIP127)
    r = g32 / scale
    q = np.clip(np.round(r), -127, 127).astype(np.int8)
    ef = (r - q.astype(np.float32)) * scale
    return q, ef, scale


def pack_grads_q8(tree: Any, ef: Any) -> Tuple[bytes, Any]:
    """Host reference for the fused device pack: error-feedback add +
    per-tensor int8 quantize + pack into one ``KIND_Q8`` wire buffer
    (offset table + scales + tile-padded payload).  Returns
    ``(wire_bytes, new_ef_tree)``, the new EF as f32 host tensors.  The
    device kernel in :mod:`repro_torch.kernels.grad_pack` must reproduce
    these bytes exactly.  Runs leaf by leaf, so host memory stays within
    a few copies of the largest leaf beside the wire."""
    specs = []
    q_segs: List[Any] = []
    scales: List[np.float32] = []
    new_ef: List[torch.Tensor] = []
    for g, e in zip(tree_leaves(tree), tree_leaves(ef)):
        g32 = _host_f32(g) + _host_f32(e)
        q, ef_leaf, scale = _q8_host(g32)
        spec = wire.leaf_spec(g, quantized=True)
        specs.append(spec)
        scales.append(scale)
        pad = wire.padded_nelems(spec.nelems) - spec.nelems
        seg = q.reshape(-1).view(np.uint8).data
        q_segs.append(seg if pad == 0 else bytes(seg) + b"\x00" * pad)
        new_ef.append(torch.from_numpy(np.asarray(ef_leaf, dtype=np.float32).reshape(spec.shape)))
    offs = wire.q8_offsets(specs)
    parts: List[Any] = [
        wire.encode_grad_header(wire.KIND_Q8, specs),
        struct.pack(f"<{len(offs)}I", *offs),
        struct.pack(f"<{len(scales)}f", *[float(s) for s in scales]),
    ]
    parts.extend(q_segs)
    return b"".join(parts), unflatten(tree, new_ef)


def make_packer(kind: str = "host") -> Callable[[Any, Any], Tuple[bytes, Any]]:
    """Resolve the explicit-DP wire packer for ``TrainConfig.grad_pack``:
    ``'host'`` is the numpy reference loop (:func:`pack_grads_q8`),
    ``'device'`` the fused pack (:func:`repro_torch.kernels.grad_pack.
    pack_grads_fused`: the CUDA kernel on a card, its plain version on the
    CPU, one device-to-host copy).  Both emit bit-identical ``KIND_Q8``
    wire bytes on finite gradients, so the knob is a pure performance
    choice."""
    if kind == "host":
        return pack_grads_q8
    if kind == "device":
        from ..kernels.grad_pack import pack_grads_fused

        return pack_grads_fused
    raise ValueError(f"grad_pack must be 'host' or 'device', got {kind!r}")
