"""HPX-style parcels and serialization (paper §2.2-2.3).

A *parcel* is the unit of communication between localities: the serialized
form of a remote action invocation.  Serialization follows the HPX layout:

* a **data chunk** holding the action metadata and every *small* argument,
* zero or more **zero-copy chunks**, one per *large* argument (an argument is
  large when it exceeds the zero-copy serialization threshold),
* a **transmission chunk** holding (index, length) of every serialized
  argument, present only when there is at least one zero-copy chunk.

Per paper §2.3 we merge the data chunk and the transmission chunk into a
single *non-zero-copy (nzc) chunk* at the parcelport boundary.

The wire protocol (paper §3.2): each parcel becomes one **header message**
(fixed-size-bounded, unexpected, location agnostic) followed by the
*follow-up* messages — the nzc chunk message and one message per zero-copy
chunk, sent sequentially per-parcel.  Small nzc chunks are piggybacked onto
the header message.

Protocol selection (paper §3.3, LCI's eager/rendezvous split): parcels whose
*total* size fits the parcelport's ``eager_threshold`` are shipped **eager**
— the nzc chunk *and* every zero-copy chunk ride inline in one fabric
message (copied through pre-registered bounce buffers, no follow-up round
trips).  Larger parcels use the **rendezvous** layout above.  On the wire
the two are distinguished by a flag bit in the header, so a receiver decodes
either from the same ``decode_header`` entry point.
"""
from __future__ import annotations

import pickle
import struct
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

# Default HPX zero-copy serialization threshold (the Octo-Tiger runs in the
# paper use 8 KiB).
DEFAULT_ZERO_COPY_THRESHOLD = 8 * 1024

# Maximum bytes of nzc chunk that may ride inside the header message
# (paper §3.2: "if the nonzero-copy chunk messages are small enough, they
# will be piggybacked onto the header message").  LCI's default medium
# message/packet size is 8KiB-ish; keep the header message size-bounded.
HEADER_PIGGYBACK_LIMIT = 8 * 1024

# Header wire layout:  parcel_id, source, dest, device_index (the LCI device
# the follow-ups will use, paper §3.3.3), n_zc_chunks, nzc_size,
# flags byte, followed by zc chunk sizes, optionally the nzc bytes, and —
# for eager messages — every zc chunk inline.
_HEADER_FMT = "<QIIIIIB"
_HEADER_FIXED = struct.calcsize(_HEADER_FMT)

FLAG_PIGGYBACK = 0x01  # nzc chunk rides in this message
FLAG_EAGER = 0x02  # zc chunks ride inline too: no follow-ups at all
FLAG_AGGREGATE = 0x04  # the nzc chunk is an aggregate of parcels (§2.2.2);
# carried out-of-band in the header so a plain parcel whose serialized
# payload happens to start with the aggregate magic byte can never be
# misparsed as one (the framing magic stays as an integrity check only)


@dataclass
class Chunk:
    """A contiguous buffer.  ``data`` is bytes-like (bytes / memoryview)."""

    data: bytes

    @property
    def size(self) -> int:
        return len(self.data)


@dataclass
class Parcel:
    """A serialized action invocation ready for the parcelport."""

    parcel_id: int
    source: int
    dest: int
    nzc_chunk: Chunk
    zc_chunks: List[Chunk] = field(default_factory=list)
    # Filled by the receiving parcelport before handing to the upper layer.
    device_index: int = 0
    # True iff nzc_chunk holds an aggregate of parcels (set by
    # aggregate_parcels, carried on the wire as FLAG_AGGREGATE).
    is_agg: bool = False

    @property
    def num_zc(self) -> int:
        return len(self.zc_chunks)

    @property
    def total_bytes(self) -> int:
        return self.nzc_chunk.size + sum(c.size for c in self.zc_chunks)


@dataclass
class Header:
    """Decoded header message."""

    parcel_id: int
    source: int
    dest: int
    device_index: int
    zc_sizes: Tuple[int, ...]
    nzc_size: int
    piggybacked_nzc: Optional[bytes]  # present iff nzc chunk rode along
    inline_zc: Optional[List[bytes]] = None  # eager messages: zc chunks inline
    is_agg: bool = False  # FLAG_AGGREGATE: the payload is an aggregate

    @property
    def is_eager(self) -> bool:
        return self.inline_zc is not None

    @property
    def num_followups(self) -> int:
        if self.inline_zc is not None:
            return 0
        n = len(self.zc_sizes)
        if self.piggybacked_nzc is None:
            n += 1
        return n


def encode_header(parcel: Parcel, device_index: int) -> bytes:
    """Encode the rendezvous header message (size-bounded by design)."""
    piggy = parcel.nzc_chunk.size <= HEADER_PIGGYBACK_LIMIT
    head = struct.pack(
        _HEADER_FMT,
        parcel.parcel_id,
        parcel.source,
        parcel.dest,
        device_index,
        len(parcel.zc_chunks),
        parcel.nzc_chunk.size,
        (FLAG_PIGGYBACK if piggy else 0) | (FLAG_AGGREGATE if parcel.is_agg else 0),
    )
    sizes = struct.pack(f"<{len(parcel.zc_chunks)}Q", *[c.size for c in parcel.zc_chunks])
    body = parcel.nzc_chunk.data if piggy else b""
    return head + sizes + body


def encode_eager(parcel: Parcel, device_index: int) -> bytes:
    """Encode the whole parcel as ONE eager message: header fields, nzc
    chunk and every zero-copy chunk inline.  The receiver copies the chunks
    out of the bounce buffer — no rendezvous round trips."""
    head = struct.pack(
        _HEADER_FMT,
        parcel.parcel_id,
        parcel.source,
        parcel.dest,
        device_index,
        len(parcel.zc_chunks),
        parcel.nzc_chunk.size,
        FLAG_PIGGYBACK | FLAG_EAGER | (FLAG_AGGREGATE if parcel.is_agg else 0),
    )
    sizes = struct.pack(f"<{len(parcel.zc_chunks)}Q", *[c.size for c in parcel.zc_chunks])
    parts = [head, sizes, parcel.nzc_chunk.data]
    parts.extend(c.data for c in parcel.zc_chunks)
    return b"".join(parts)


def eager_wire_size(parcel: Parcel) -> int:
    """Size of :func:`encode_eager`'s output without building it (used to
    check bounce-buffer capacity before choosing the eager path)."""
    return _HEADER_FIXED + 8 * len(parcel.zc_chunks) + parcel.total_bytes


def decode_header(buf: bytes) -> Header:
    (pid, src, dst, dev, n_zc, nzc_size, flags) = struct.unpack_from(_HEADER_FMT, buf, 0)
    off = _HEADER_FIXED
    zc_sizes = struct.unpack_from(f"<{n_zc}Q", buf, off)
    off += 8 * n_zc
    piggy_nzc = bytes(buf[off : off + nzc_size]) if flags & FLAG_PIGGYBACK else None
    inline_zc: Optional[List[bytes]] = None
    if flags & FLAG_EAGER:
        off += nzc_size
        inline_zc = []
        for sz in zc_sizes:
            inline_zc.append(bytes(buf[off : off + sz]))
            off += sz
    return Header(
        parcel_id=pid,
        source=src,
        dest=dst,
        device_index=dev,
        zc_sizes=tuple(zc_sizes),
        nzc_size=nzc_size,
        piggybacked_nzc=piggy_nzc,
        inline_zc=inline_zc,
        is_agg=bool(flags & FLAG_AGGREGATE),
    )


# ---------------------------------------------------------------------------
# Action serialization (the HPX "upper communication layer", paper §2.2.2)
# ---------------------------------------------------------------------------

class _ZcPlaceholder:
    """Marks where a zero-copy argument sat in the argument tuple."""

    __slots__ = ("index", "length")

    def __init__(self, index: int, length: int):
        self.index = index
        self.length = length


def serialize_action(
    parcel_id: int,
    source: int,
    dest: int,
    action: str,
    args: Sequence[Any],
    zero_copy_threshold: int = DEFAULT_ZERO_COPY_THRESHOLD,
) -> Parcel:
    """Serialize an action invocation into a parcel.

    Arguments that are bytes-like and exceed the threshold become zero-copy
    chunks (never copied into the pickle stream); everything else is
    pickled into the data chunk.  The transmission record (index, length per
    zero-copy chunk) is appended to the same nzc chunk, mirroring HPX's
    merged data+transmission chunk.
    """
    zc_chunks: List[Chunk] = []
    small_args: List[Any] = []
    for a in args:
        if isinstance(a, (bytes, bytearray, memoryview)) and len(a) >= zero_copy_threshold:
            small_args.append(_ZcPlaceholder(len(zc_chunks), len(a)))
            zc_chunks.append(Chunk(bytes(a)))
        else:
            small_args.append(a)
    payload = pickle.dumps((action, small_args), protocol=pickle.HIGHEST_PROTOCOL)
    # transmission record
    trans = struct.pack(f"<I{len(zc_chunks)}Q", len(zc_chunks), *[c.size for c in zc_chunks])
    nzc = Chunk(struct.pack("<I", len(payload)) + payload + trans)
    return Parcel(parcel_id=parcel_id, source=source, dest=dest, nzc_chunk=nzc, zc_chunks=zc_chunks)


def deserialize_action(parcel: Parcel) -> Tuple[str, List[Any]]:
    """Inverse of :func:`serialize_action`."""
    buf = parcel.nzc_chunk.data
    (plen,) = struct.unpack_from("<I", buf, 0)
    action, small_args = pickle.loads(buf[4 : 4 + plen])
    (n_zc,) = struct.unpack_from("<I", buf, 4 + plen)
    if n_zc != len(parcel.zc_chunks):
        raise ValueError(
            f"transmission chunk says {n_zc} zero-copy chunks, parcel has {len(parcel.zc_chunks)}"
        )
    args: List[Any] = []
    for a in small_args:
        if isinstance(a, _ZcPlaceholder):
            chunk = parcel.zc_chunks[a.index]
            if chunk.size != a.length:
                raise ValueError("zero-copy chunk length mismatch")
            args.append(chunk.data)
        else:
            args.append(a)
    return action, args


def zc_sizes_from_nzc(nzc_data: bytes) -> Tuple[int, ...]:
    """Read the zero-copy sizes out of an nzc chunk (``allocate_zc_chunks``
    uses this: the nzc chunk carries the size info, paper §2.3)."""
    (plen,) = struct.unpack_from("<I", nzc_data, 0)
    (n_zc,) = struct.unpack_from("<I", nzc_data, 4 + plen)
    return struct.unpack_from(f"<{n_zc}Q", nzc_data, 8 + plen)


# Callback type used throughout the parcelport layer.
SendCallback = Callable[[Parcel], None]
