"""Port parity: parcels, their serialization and their wire bytes.

``tests/test_parcel.py``'s checks on ``repro_torch.core.parcel``, each held
against the reference, and the byte contract between the two packages:

* every ``encode_*`` output — headers, eager frames — is the reference's
  bit for bit on the same parcel, and so are zero-copy chunks and the
  transmission record;
* an nzc chunk without a zero-copy placeholder is the reference's bit for
  bit; with one it is exactly 6 bytes longer: pickle names the
  placeholder's class by its module, ``repro_torch.core.parcel`` against
  ``repro.core.parcel``, and nothing else differs (the pickle's frame
  length and the ``<I`` length prefix count those 6 bytes);
* ``deserialize_action`` gives equal ``(action, args)``.
"""
import importlib
import pickle
import struct

import pytest
from _hypothesis_compat import given, settings, st

from repro.core import parcel as jparcel
from repro.core import parcelport as jparcelport
from repro_torch.core.parcel import (
    Chunk,
    Parcel,
    decode_header,
    encode_header,
    deserialize_action,
    serialize_action,
    zc_sizes_from_nzc,
)
from repro_torch.core import parcel as tparcel
from repro_torch.core.parcelport import aggregate_parcels, is_aggregate, split_aggregate

#: the 6 bytes the port's placeholder class name adds to a pickle
PLACEHOLDER_DELTA = len("repro_torch") - len("repro")


def mk(pid, args, threshold=256, mod=tparcel):
    return mod.serialize_action(pid, 0, 1, "act", args, zero_copy_threshold=threshold)


def expected_port_nzc(ref_nzc: bytes, n_zc: int) -> bytes:
    """The nzc chunk the port must produce, derived from the reference's:
    the placeholder's module name re-spelled, the frame length and the
    ``<I`` payload length grown by the 6 bytes, the rest unchanged."""
    if n_zc == 0:
        return ref_nzc
    (plen,) = struct.unpack_from("<I", ref_nzc, 0)
    payload, trans = ref_nzc[4 : 4 + plen], ref_nzc[4 + plen :]
    old, new = b"repro.core.parcel", b"repro_torch.core.parcel"
    a, b = bytes([0x8C, len(old)]) + old, bytes([0x8C, len(new)]) + new  # SHORT_BINUNICODE
    assert payload.count(a) == 1
    payload = payload.replace(a, b)
    if payload[2] == pickle.FRAME[0]:  # protocol 4+: one frame over the rest
        (flen,) = struct.unpack_from("<Q", payload, 3)
        payload = payload[:3] + struct.pack("<Q", flen + PLACEHOLDER_DELTA) + payload[11:]
    return struct.pack("<I", len(payload)) + payload + trans


def _port_copy(p) -> Parcel:
    """The reference parcel's bytes as a port parcel (same nzc, same chunks)."""
    return Parcel(parcel_id=p.parcel_id, source=p.source, dest=p.dest, nzc_chunk=Chunk(p.nzc_chunk.data),
                  zc_chunks=[Chunk(c.data) for c in p.zc_chunks], is_agg=p.is_agg)


def _assert_byte_contract(args, threshold):
    jp = mk(9, args, threshold, mod=jparcel)
    tp = mk(9, args, threshold)
    assert [c.data for c in tp.zc_chunks] == [c.data for c in jp.zc_chunks]
    assert tp.nzc_chunk.data == expected_port_nzc(jp.nzc_chunk.data, jp.num_zc)
    assert tp.nzc_chunk.size == jp.nzc_chunk.size + (PLACEHOLDER_DELTA if jp.num_zc else 0)
    # the transmission record, the nzc chunk's tail, is the reference's bit for bit
    n = 4 + 8 * jp.num_zc
    assert tp.nzc_chunk.data[-n:] == jp.nzc_chunk.data[-n:]
    assert tparcel.zc_sizes_from_nzc(tp.nzc_chunk.data) == jparcel.zc_sizes_from_nzc(jp.nzc_chunk.data)
    assert tparcel.deserialize_action(tp) == jparcel.deserialize_action(jp)
    # the encoders on the same parcel: bit for bit
    same = _port_copy(jp)
    for dev in (0, 3):
        assert tparcel.encode_header(same, dev) == jparcel.encode_header(jp, dev)
        assert tparcel.encode_eager(same, dev) == jparcel.encode_eager(jp, dev)
    assert tparcel.eager_wire_size(same) == jparcel.eager_wire_size(jp)
    return jp, tp


def test_roundtrip_small_args():
    p = mk(1, (b"abc", b"d" * 10))
    action, args = deserialize_action(p)
    assert action == "act"
    assert args == [b"abc", b"d" * 10]
    assert p.num_zc == 0  # all below threshold
    jp, _ = _assert_byte_contract((b"abc", b"d" * 10), 256)
    assert p.nzc_chunk.data == jp.nzc_chunk.data  # no placeholder: bit for bit


def test_zero_copy_threshold():
    big = b"x" * 1000
    p = mk(2, (b"small", big), threshold=256)
    assert p.num_zc == 1
    assert p.zc_chunks[0].size == 1000
    action, args = deserialize_action(p)
    assert args == [b"small", big]
    _assert_byte_contract((b"small", big), 256)


def test_zc_sizes_from_nzc():
    p = mk(3, (b"a" * 500, b"b" * 700), threshold=256)
    sizes = zc_sizes_from_nzc(p.nzc_chunk.data)
    assert tuple(sizes) == (500, 700)
    _assert_byte_contract((b"a" * 500, b"b" * 700), 256)


def test_header_roundtrip():
    p = mk(4, (b"y" * 5000,), threshold=256)
    hdr = encode_header(p, device_index=3)
    h = decode_header(hdr)
    assert h.num_followups >= 1
    jh = jparcel.decode_header(jparcel.encode_header(mk(4, (b"y" * 5000,), 256, mod=jparcel), 3))
    assert (h.num_followups, h.zc_sizes, h.device_index) == (jh.num_followups, jh.zc_sizes, jh.device_index)
    assert h.nzc_size == jh.nzc_size + PLACEHOLDER_DELTA


@pytest.mark.parametrize("n_zc", [1, 2, 5])
def test_placeholder_delta_is_six_bytes_whatever_their_number(n_zc):
    """Pickle memoizes the class: one module name a pickle, so the nzc chunk
    grows by 6 bytes however many zero-copy arguments a parcel carries."""
    args = tuple(bytes([i]) * (300 + i) for i in range(n_zc)) + (b"meta", 7, "s")
    jp, tp = _assert_byte_contract(args, 256)
    assert tp.nzc_chunk.size - jp.nzc_chunk.size == PLACEHOLDER_DELTA


@pytest.mark.parametrize("size", [1, 100, 8 * 1024, 9 * 1024])
def test_headers_piggyback_and_decode_as_the_reference(size):
    """Around the piggyback limit (8 KiB of nzc) the two decoders agree on
    the same header bytes, both ways."""
    jp = mk(11, (b"q" * size,), threshold=1 << 30, mod=jparcel)
    same = _port_copy(jp)
    wire = jparcel.encode_header(jp, 2)
    assert tparcel.encode_header(same, 2) == wire
    a, b = tparcel.decode_header(wire), jparcel.decode_header(wire)
    assert (a.parcel_id, a.source, a.dest, a.device_index, a.zc_sizes, a.nzc_size, a.piggybacked_nzc,
            a.is_agg, a.num_followups) == (b.parcel_id, b.source, b.dest, b.device_index, b.zc_sizes, b.nzc_size,
                                           b.piggybacked_nzc, b.is_agg, b.num_followups)


@settings(max_examples=50, deadline=None)
@given(
    st.lists(st.binary(min_size=0, max_size=2048), min_size=1, max_size=5),
    st.integers(min_value=16, max_value=1024),
)
def test_roundtrip_property(args, threshold):
    p = serialize_action(7, 0, 1, "a", tuple(args), zero_copy_threshold=threshold)
    action, out = deserialize_action(p)
    assert out == list(args)
    for a in args:
        if len(a) > threshold:
            assert any(c.size == len(a) for c in p.zc_chunks)
    _assert_byte_contract(tuple(args), threshold)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.binary(min_size=1, max_size=512), min_size=1, max_size=8))
def test_aggregation_roundtrip(payloads):
    parcels = [mk(10 + i, (pl,)) for i, pl in enumerate(payloads)]
    agg = aggregate_parcels(parcels)
    assert is_aggregate(agg)
    back = split_aggregate(agg)
    assert len(back) == len(parcels)
    for orig, got in zip(parcels, back):
        a1, args1 = deserialize_action(orig)
        a2, args2 = deserialize_action(got)
        assert (a1, args1) == (a2, args2)
    # the aggregate of the reference's parcels: the same bytes in both packages
    jparcels = [mk(10 + i, (pl,), mod=jparcel) for i, pl in enumerate(payloads)]
    jagg = jparcelport.aggregate_parcels(jparcels)
    tagg = aggregate_parcels([_port_copy(p) for p in jparcels])
    assert tagg.nzc_chunk.data == jagg.nzc_chunk.data and tagg.parcel_id == jagg.parcel_id
    assert [p.parcel_id for p in split_aggregate(tagg)] == [p.parcel_id for p in jparcelport.split_aggregate(jagg)]


def test_parcel_constants_match_the_reference():
    for name in ("DEFAULT_ZERO_COPY_THRESHOLD", "HEADER_PIGGYBACK_LIMIT", "_HEADER_FMT", "_HEADER_FIXED",
                 "FLAG_PIGGYBACK", "FLAG_EAGER", "FLAG_AGGREGATE"):
        assert getattr(tparcel, name) == getattr(jparcel, name), name
    base_t, base_j = importlib.import_module("repro_torch.core.comm.base"), importlib.import_module("repro.core.comm.base")
    for name in ("AGG_MAGIC", "AGG_SUB_SHIFT", "AGG_MAX_PARCELS", "AGG_PREAMBLE_BYTES", "AGG_PER_PARCEL_BYTES"):
        assert getattr(base_t, name) == getattr(base_j, name), name
