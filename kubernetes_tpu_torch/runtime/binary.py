"""Binary wire format (the protobuf content-type analogue).

The reference serves JSON and protobuf; kubemark runs protobuf because
reflective JSON codec cost dominates control-plane CPU at 1000-node
scale (hollow-node.go:65, runtime/serializer/protobuf/protobuf.go). The
equivalent binary serializer here is a magic-prefixed TLV envelope
(runtime/tlv.py) whose per-class marshalling plan is generated from the
dataclass fields — the generated-marshaller analogue, data-only.

Negotiation mirrors the reference: clients send Content-Type/Accept
`application/vnd.kubernetes-tpu.binary` and the HTTP frontend answers in
kind; JSON remains the default and the interop format. Watch streams
frame events as length-prefixed envelopes instead of NDJSON.

Decoding only ever yields registered API dataclasses, dicts, lists and
scalars — no code execution paths — so, like the reference's protobuf,
this content type is safe to serve to untrusted callers.

Copy of kubernetes_tpu/runtime/binary.py: only the import package differs.
"""

from __future__ import annotations

import struct
from typing import Any

from kubernetes_tpu_torch.runtime import tlv
from kubernetes_tpu_torch.trace.profile import phase_timer

CONTENT_TYPE = "application/vnd.kubernetes-tpu.binary"
# protobuf.go:17-33 magic-prefixed envelope idea; the trailing byte is a
# format version (0 was the retired pickle envelope)
MAGIC = b"k8s-tpu\x01"
# segmented list envelope (version 2): a head TLV value followed by N
# independently self-contained item TLV values, each length-prefixed.
# The apiserver splices each item's commit-time bytes verbatim (TLV
# class-table ids are sequential per VALUE, so items cannot share one
# outer table — segmentation is what makes zero-re-encode lists sound);
# the client decodes head + items back into the ordinary List payload.
MAGIC_SEG = b"k8s-tpu\x02"
# coalesced watch burst (version 3): ONE length-prefixed frame carrying
# N watch events — per event a 1-byte-length type string and a
# length-prefixed self-contained object TLV value (spliced verbatim
# from the commit-time bytes). A bind storm's whole burst becomes one
# frame and one write syscall per connection; the client fans it back
# out into ordinary {"type","object"} events.
MAGIC_BURST = b"k8s-tpu\x03"
_LEN = struct.Struct("<I")
_U8 = struct.Struct("<B")


class BinaryDecodeError(Exception):
    pass


class RawObject:
    """A handler payload that is ALREADY the object's commit-time TLV
    bytes: the frontend writes MAGIC + blob verbatim, re-encoding
    nothing."""

    __slots__ = ("blob",)

    def __init__(self, blob: bytes):
        self.blob = blob


class RawList:
    """A list payload as (head dict sans items, pre-encoded item
    blobs): the frontend writes the segmented envelope by
    concatenation."""

    __slots__ = ("head", "blobs")

    def __init__(self, head: dict, blobs: list):
        self.head = head
        self.blobs = blobs


def encode(payload: Any) -> bytes:
    """Envelope any handler payload (API object, list dict carrying
    objects, Status dict). Raw payloads splice their stored bytes."""
    if type(payload) is RawObject:
        return MAGIC + payload.blob
    if type(payload) is RawList:
        head = tlv.dumps(payload.head)
        parts = [MAGIC_SEG, _LEN.pack(len(head)), head,
                 _LEN.pack(len(payload.blobs))]
        for blob in payload.blobs:
            parts.append(_LEN.pack(len(blob)))
            parts.append(blob)
        return b"".join(parts)
    return MAGIC + tlv.dumps(payload)


def decode(data: bytes) -> Any:
    if data.startswith(MAGIC_SEG):
        return _decode_segmented(data)
    if not data.startswith(MAGIC):
        raise BinaryDecodeError("missing binary envelope magic")
    try:
        return tlv.loads(data[len(MAGIC):])
    except tlv.TLVError as e:
        raise BinaryDecodeError(str(e)) from e


def _decode_segmented(data: bytes) -> Any:
    pos = len(MAGIC_SEG)
    try:
        def take() -> bytes:
            nonlocal pos
            if pos + _LEN.size > len(data):
                raise BinaryDecodeError("truncated segmented envelope")
            (n,) = _LEN.unpack_from(data, pos)
            pos += _LEN.size
            if pos + n > len(data):
                raise BinaryDecodeError("truncated segmented envelope")
            out = data[pos:pos + n]
            pos += n
            return out

        head = tlv.loads(take())
        if not isinstance(head, dict):
            raise BinaryDecodeError("segmented head is not a dict")
        if pos + _LEN.size > len(data):
            raise BinaryDecodeError("truncated segmented envelope")
        (count,) = _LEN.unpack_from(data, pos)
        pos += _LEN.size
        if count > len(data) - pos:  # every item is >= 1 byte + prefix
            raise BinaryDecodeError("segmented count exceeds input")
        head["items"] = [tlv.loads(take()) for _ in range(count)]
        if pos != len(data):
            raise BinaryDecodeError("trailing bytes after segmented list")
        return head
    except tlv.TLVError as e:
        raise BinaryDecodeError(str(e)) from e


def encode_frame(payload: Any) -> bytes:
    """One length-prefixed watch frame."""
    body = encode(payload)
    return _LEN.pack(len(body)) + body


def splice_frame(ev_type: str, obj_tlv: bytes) -> bytes:
    """Build the frame for {"type": ev_type, "object": <obj>} by
    splicing the object's pre-encoded TLV value verbatim — the store
    encodes each commit once and every binary watcher reuses the bytes.
    Valid because a TLV value is self-contained (its class table ids
    are sequential from the first OBJDEF inside it) and the wrapping
    dict introduces no classes of its own."""
    tb = ev_type.encode()
    head = bytes(
        [tlv.DICT, 2, tlv.STR, 4]) + b"type" + bytes(
        [tlv.STR, len(tb)]) + tb + bytes([tlv.STR, 6]) + b"object"
    body_len = len(MAGIC) + len(head) + len(obj_tlv)
    return b"".join((_LEN.pack(body_len), MAGIC, head, obj_tlv))


def coalesce_burst(items) -> bytes:
    """ONE length-prefixed burst frame from [(ev_type, obj_tlv_bytes)]:
    the whole watch burst is a single frame (single write syscall), and
    each object's TLV bytes are spliced verbatim — the splice_frame
    zero-re-encode contract, amortized over the burst."""
    parts = [MAGIC_BURST, _LEN.pack(len(items))]
    size = len(MAGIC_BURST) + _LEN.size
    for ev_type, ob in items:
        tb = ev_type.encode()
        parts.append(_U8.pack(len(tb)))
        parts.append(tb)
        parts.append(_LEN.pack(len(ob)))
        parts.append(ob)
        size += 1 + len(tb) + _LEN.size + len(ob)
    return b"".join([_LEN.pack(size)] + parts)


def iter_burst(body: bytes):
    """Yield the {"type", "object"} events of one burst frame body
    (everything after the frame's length prefix)."""
    pos = len(MAGIC_BURST)
    try:
        (count,) = _LEN.unpack_from(body, pos)
        pos += _LEN.size
        for _ in range(count):
            tlen = body[pos]
            pos += 1
            ev_type = body[pos:pos + tlen].decode()
            pos += tlen
            (n,) = _LEN.unpack_from(body, pos)
            pos += _LEN.size
            if pos + n > len(body):
                raise BinaryDecodeError("truncated burst frame")
            yield {"type": ev_type, "object": tlv.loads(body[pos:pos + n])}
            pos += n
    except (struct.error, IndexError) as e:
        raise BinaryDecodeError(f"malformed burst frame: {e}") from e
    except tlv.TLVError as e:
        raise BinaryDecodeError(str(e)) from e
    if pos != len(body):
        raise BinaryDecodeError("trailing bytes after burst frame")


def read_frames(fp):
    """Yield decoded frames from a binary watch stream until EOF.

    Reads in large blocks and parses frames out of a local buffer: the
    underlying stream is http.client's chunked reader, whose per-call
    bookkeeping would otherwise run twice per frame — measurable at
    watch-storm rates (tens of thousands of events in a burst). A
    partial frame at the end of a block just waits for the next read."""
    buf = b""
    pos = 0
    hdr = _LEN.size
    while True:
        avail = len(buf) - pos
        if avail >= hdr:
            (n,) = _LEN.unpack_from(buf, pos)
            if avail >= hdr + n:
                body = buf[pos + hdr:pos + hdr + n]
                pos += hdr + n
                # "wire" phase: the CPU cost of the TLV watch ingest
                # (decode only — the blocking read below is idle time,
                # not work, and must not inflate the attribution)
                if body.startswith(MAGIC_BURST):
                    # coalesced burst: one frame fans back out into its
                    # individual events
                    with phase_timer("wire"):
                        events = list(iter_burst(body))
                    yield from events
                    continue
                with phase_timer("wire"):
                    obj = decode(body)
                yield obj
                continue
        # compact + refill (read1: return as soon as any data arrives —
        # a frame must not wait for a full block on a quiet stream)
        buf = buf[pos:]
        pos = 0
        more = (fp.read1(65536) if hasattr(fp, "read1")
                else fp.read(1))
        if not more:
            return
        buf += more
