"""In-memory snapshot codec for live state handoff.

Port of ``repro/checkpoint/snapshot.py``: the checkpoint manager's
self-describing, bit-exact encoding as **bytes**, so that state can move
between processes over a channel.  The bytes equal the reference's for the
same tree and ``meta``: the same manifest (key order, JSON formatting,
numpy dtype names), the same offsets, and bf16 leaves as their ``uint16``
bits with the logical dtype in the manifest.

Wire format: ``b"RSNP"`` + 4-byte big-endian manifest length + manifest
JSON + concatenated raw leaf bytes.  The manifest carries per-leaf
dtype/shape/offset plus a JSON ``meta`` dict for scalar bookkeeping
(request id, position, remaining budget).
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import unflatten
from .manager import _dtype_name, _flatten, _from_host, _to_host

__all__ = ["pack_state", "unpack_state"]

_MAGIC = b"RSNP"


def pack_state(tree: Any, meta: Optional[Dict[str, Any]] = None) -> bytes:
    """Serialize a tree of tensors or arrays (+ JSON-able ``meta``) to bytes."""
    manifest: Dict[str, Any] = {"meta": meta or {}, "leaves": {}}
    blobs = []
    offset = 0
    for key, leaf in _flatten(tree):
        arr, dt = _to_host(leaf)
        data = np.ascontiguousarray(arr).tobytes()
        manifest["leaves"][key] = {
            "dtype": dt,  # logical dtype (what the consumer sees)
            "raw": str(arr.dtype),  # storage dtype (what the bytes are)
            "shape": list(arr.shape),
            "offset": offset,
            "nbytes": len(data),
        }
        blobs.append(data)
        offset += len(data)
    mjson = json.dumps(manifest).encode()
    return _MAGIC + struct.pack(">I", len(mjson)) + mjson + b"".join(blobs)


def unpack_state(payload: bytes, abstract: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Decode :func:`pack_state` bytes → ``(state, meta)``.

    Without ``abstract``, ``state`` is a flat ``{tree-path: tensor}`` dict of
    CPU tensors.  With ``abstract`` (a tree of tensors giving each leaf's
    shape, dtype and device, e.g. the adopter's own freshly allocated slot
    state) the original structure is rebuilt as new tensors on the
    abstract leaves' devices, failing loudly on any shape or dtype
    mismatch."""
    if payload[:4] != _MAGIC:
        raise ValueError("not a snapshot payload (bad magic)")
    (mlen,) = struct.unpack(">I", payload[4:8])
    manifest = json.loads(payload[8 : 8 + mlen].decode())
    base = 8 + mlen
    arrays: Dict[str, torch.Tensor] = {}
    for key, ent in manifest["leaves"].items():
        lo = base + ent["offset"]
        raw = np.frombuffer(payload[lo : lo + ent["nbytes"]], dtype=np.dtype(ent["raw"]))
        arrays[key] = _from_host(raw.reshape(ent["shape"]), ent["dtype"], f"leaf {key}")
    meta = manifest["meta"]
    if abstract is None:
        return arrays, meta
    ordered = []
    for key, ref in _flatten(abstract):
        if key not in arrays:
            raise KeyError(f"snapshot missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {key}: snapshot shape {tuple(arr.shape)} != target {tuple(ref.shape)}")
        if _dtype_name(ref.dtype) != manifest["leaves"][key]["dtype"]:
            raise ValueError(
                f"leaf {key}: snapshot dtype {manifest['leaves'][key]['dtype']} != target {_dtype_name(ref.dtype)}"
            )
        ordered.append(arr.to(getattr(ref, "device", "cpu")))
    return unflatten(abstract, ordered), meta
