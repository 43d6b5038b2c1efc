"""Control-plane message codec of the serving hand-off.

Port's copy of :func:`encode_msg` / :func:`decode_msg` from
``repro/core/comm/wire.py``: a small tagged, versioned, length-prefixed
binary encoding of the serving stack's request/response tuples (ints,
floats, bools, str, bytes, lists, tuples, dicts).  Deterministic and free
of pickle; the bytes are identical to the reference's.  The gradient wire
header waits for the training slice.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

__all__ = ["MSG_MAGIC", "MSG_VERSION", "encode_msg", "decode_msg"]

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
