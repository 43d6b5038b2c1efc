"""Pickle-free wire formats: the gradient wire and the control-plane codec.

Port of ``repro/core/comm/wire.py``, both halves, with bytes identical to
the reference's:

* **gradient wire format** (:func:`encode_grad_header` /
  :func:`parse_grad_header`) — the header that the host pack
  (:mod:`repro_torch.train.grad_sync`) and the device pack
  (:mod:`repro_torch.kernels.grad_pack`) both emit.  Two body kinds:
  ``KIND_RAW`` (leaf bytes, tightly concatenated) and ``KIND_Q8`` (offset
  table + per-tensor f32 scales + tile-padded int8 payload).  Where the
  reference goes through ``np.dtype`` (and bf16 through ``ml_dtypes``),
  the port maps ``torch.dtype`` to the same wire codes directly.
* **control-plane message codec** (:func:`encode_msg` / :func:`decode_msg`)
  — a small tagged, versioned, length-prefixed binary encoding of the
  serving stack's request/response tuples (ints, floats, bools, str,
  bytes, lists, tuples, dicts).  Deterministic and free of pickle.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "GRAD_MAGIC",
    "GRAD_VERSION",
    "KIND_RAW",
    "KIND_Q8",
    "PACK_TILE",
    "LeafSpec",
    "dtype_code",
    "code_dtype",
    "leaf_spec",
    "encode_grad_header",
    "parse_grad_header",
    "grad_header_bytes",
    "padded_nelems",
    "q8_offsets",
    "MSG_MAGIC",
    "MSG_VERSION",
    "encode_msg",
    "decode_msg",
]

# ---------------------------------------------------------------------------
# Gradient wire format (shared by host + device pack paths)
# ---------------------------------------------------------------------------

GRAD_MAGIC = 0xB7
GRAD_VERSION = 1
KIND_RAW = 0  # body: leaf bytes, tightly concatenated in leaf order
KIND_Q8 = 1  # body: offset table (u32/leaf) + scales (f32/leaf) + int8 payload

# The device pack kernel's tile, in ELEMENTS: every leaf's quantized
# payload segment is padded to a PACK_TILE multiple so tiles never straddle
# leaves.  The host path mirrors the padding exactly (zero bytes), which is
# what makes host and device wire bytes bit-comparable.
PACK_TILE = 1024

# dtype registry: code on the wire <-> torch dtype, the reference's code
# table.  bf16 is a torch dtype of its own; no numpy bf16 is involved.  A
# torch without ``uint32`` (before 2.3) simply has no code 8.
_DTYPES: List[Tuple[int, str]] = [
    (0, "float32"),
    (1, "bfloat16"),
    (2, "float16"),
    (3, "int8"),
    (4, "int16"),
    (5, "int32"),
    (6, "int64"),
    (7, "uint8"),
    (8, "uint32"),
    (9, "float64"),
    (10, "bool"),
]
_CODE_TO_DTYPE: Dict[int, torch.dtype] = {c: getattr(torch, n) for c, n in _DTYPES if hasattr(torch, n)}
_DTYPE_TO_CODE: Dict[torch.dtype, int] = {dt: c for c, dt in _CODE_TO_DTYPE.items()}


def dtype_code(dt: torch.dtype) -> int:
    try:
        return _DTYPE_TO_CODE[dt]
    except KeyError:
        raise ValueError(f"dtype {dt!r} has no gradient-wire code") from None


def code_dtype(code: int) -> torch.dtype:
    try:
        return _CODE_TO_DTYPE[code]
    except KeyError:
        raise ValueError(f"unknown gradient-wire dtype code {code}") from None


@dataclass(frozen=True)
class LeafSpec:
    """One leaf's wire metadata: original dtype, shape, and payload bytes
    (raw: ``nelems * itemsize``; q8: ``nelems`` — one int8 byte per
    element, padding excluded)."""

    code: int
    shape: Tuple[int, ...]
    nbytes: int

    @property
    def dtype(self) -> torch.dtype:
        return code_dtype(self.code)

    @property
    def nelems(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


def leaf_spec(t: torch.Tensor, *, quantized: bool = False) -> LeafSpec:
    shape = tuple(int(d) for d in t.shape)
    n = t.numel()
    nbytes = n if quantized else n * t.element_size()
    return LeafSpec(dtype_code(t.dtype), shape, nbytes)


# header layout: <BBBB I> magic, version, kind, reserved, n_leaves; then per
# leaf <BBH I> dtype_code, ndim, reserved, nbytes followed by ndim × <I>.
_HEAD_FMT = "<BBBBI"
_HEAD_BYTES = struct.calcsize(_HEAD_FMT)
_LEAF_FMT = "<BBHI"
_LEAF_BYTES = struct.calcsize(_LEAF_FMT)


def encode_grad_header(kind: int, specs: Sequence[LeafSpec]) -> bytes:
    parts = [struct.pack(_HEAD_FMT, GRAD_MAGIC, GRAD_VERSION, kind, 0, len(specs))]
    for s in specs:
        parts.append(struct.pack(_LEAF_FMT, s.code, len(s.shape), 0, s.nbytes))
        parts.append(struct.pack(f"<{len(s.shape)}I", *s.shape))
    return b"".join(parts)


def grad_header_bytes(specs: Sequence[LeafSpec]) -> int:
    """Size of :func:`encode_grad_header`'s output without building it."""
    return _HEAD_BYTES + sum(_LEAF_BYTES + 4 * len(s.shape) for s in specs)


def parse_grad_header(buf) -> Tuple[int, List[LeafSpec], int]:
    """Returns ``(kind, specs, body_offset)``; ``buf`` is any bytes-like."""
    magic, version, kind, _r, n = struct.unpack_from(_HEAD_FMT, buf, 0)
    if magic != GRAD_MAGIC:
        raise ValueError(f"not a gradient wire payload (magic {magic:#x})")
    if version != GRAD_VERSION:
        raise ValueError(f"gradient wire version {version} not supported")
    off = _HEAD_BYTES
    specs: List[LeafSpec] = []
    for _ in range(n):
        code, ndim, _r2, nbytes = struct.unpack_from(_LEAF_FMT, buf, off)
        off += _LEAF_BYTES
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
        off += 4 * ndim
        specs.append(LeafSpec(code, tuple(shape), nbytes))
    return kind, specs, off


def padded_nelems(nelems: int) -> int:
    """A leaf's q8 payload segment, padded to the kernel tile."""
    if nelems <= 0:
        return 0
    return -(-nelems // PACK_TILE) * PACK_TILE


def q8_offsets(specs: Sequence[LeafSpec]) -> List[int]:
    """Byte offset of each leaf's segment inside the padded q8 payload
    region (1 byte per element, tile-padded) — the wire's offset table."""
    offs, cur = [], 0
    for s in specs:
        offs.append(cur)
        cur += padded_nelems(s.nelems)
    return offs


# ---------------------------------------------------------------------------
# Control-plane message codec (the serving request/response tuples)
# ---------------------------------------------------------------------------

MSG_MAGIC = 0xC3
MSG_VERSION = 1

_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03  # <q>
_T_FLOAT = 0x04  # <d>
_T_STR = 0x05  # <I> + utf8
_T_BYTES = 0x06  # <I> + raw
_T_LIST = 0x07  # <I> + items
_T_TUPLE = 0x08  # <I> + items
_T_DICT = 0x09  # <I> + key/value pairs


def _enc(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\x00")
    elif isinstance(obj, bool) or isinstance(obj, np.bool_):
        out.append(b"\x02" if obj else b"\x01")
    elif isinstance(obj, (int, np.integer)):
        out.append(struct.pack("<Bq", _T_INT, int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(struct.pack("<Bd", _T_FLOAT, float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(struct.pack("<BI", _T_STR, len(raw)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out.append(struct.pack("<BI", _T_BYTES, len(obj)))
        out.append(bytes(obj) if not isinstance(obj, bytes) else obj)
    elif isinstance(obj, (list, tuple)):
        tag = _T_LIST if isinstance(obj, list) else _T_TUPLE
        out.append(struct.pack("<BI", tag, len(obj)))
        for item in obj:
            _enc(item, out)
    elif isinstance(obj, dict):
        out.append(struct.pack("<BI", _T_DICT, len(obj)))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    else:
        raise TypeError(
            f"control-plane codec cannot encode {type(obj).__name__} — the "
            "wire carries plain ints/floats/str/bytes/containers only"
        )


def _dec(buf, off: int) -> Tuple[Any, int]:
    tag = buf[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_FALSE:
        return False, off
    if tag == _T_TRUE:
        return True, off
    if tag == _T_INT:
        (v,) = struct.unpack_from("<q", buf, off)
        return v, off + 8
    if tag == _T_FLOAT:
        (v,) = struct.unpack_from("<d", buf, off)
        return v, off + 8
    if tag == _T_STR:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        return bytes(buf[off : off + n]).decode("utf-8"), off + n
    if tag == _T_BYTES:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        return bytes(buf[off : off + n]), off + n
    if tag in (_T_LIST, _T_TUPLE):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        items = []
        for _ in range(n):
            v, off = _dec(buf, off)
            items.append(v)
        return (items if tag == _T_LIST else tuple(items)), off
    if tag == _T_DICT:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(buf, off)
            v, off = _dec(buf, off)
            d[k] = v
        return d, off
    raise ValueError(f"control-plane codec: unknown tag {tag:#x} at offset {off - 1}")


def encode_msg(obj: Any) -> bytes:
    """Encode one control-plane message (nested ints/floats/bools/str/
    bytes/lists/tuples/dicts) to versioned wire bytes."""
    out: List[bytes] = [struct.pack("<BB", MSG_MAGIC, MSG_VERSION)]
    _enc(obj, out)
    return b"".join(out)


def decode_msg(data) -> Any:
    """Inverse of :func:`encode_msg`; accepts any bytes-like."""
    buf = memoryview(data) if not isinstance(data, (bytes, bytearray)) else data
    magic, version = buf[0], buf[1]
    if magic != MSG_MAGIC:
        raise ValueError(f"not a control-plane message (magic {magic:#x})")
    if version != MSG_VERSION:
        raise ValueError(f"control-plane message version {version} not supported")
    obj, off = _dec(buf, 2)
    if off != len(buf):
        raise ValueError(f"trailing bytes after message ({len(buf) - off})")
    return obj
