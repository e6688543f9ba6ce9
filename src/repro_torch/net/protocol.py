"""Wire protocol shared by the switch daemon and the client transport.

A copy of the JAX package's ``repro/net/protocol.py`` (pure numpy and
sockets): the frame bytes are the same, so a client of either package
talks to a daemon of the other.

Frame layout (all integers big-endian)::

    frame   := u32 body_len | body                      (body_len <= 16 MiB)
    body    := u8 kind | rest
    HELLO   := kind=1 | json {flow, w_max, proto}
    OP      := kind=2 | u32 flow | u32 seq | u8 flip | u16 frag | u16 nfrags
               | fragment bytes
    ACK     := kind=3 | u32 flow | u32 seq | u8 ecn | u8 applied
               | u16 frag | u16 nfrags | fragment bytes
    CTRL    := kind=4 | json {cmd, ...}

An *op* (one reliable unit, one seq in the sliding window) is encoded
once and fragmented into <= MTU fragments; the receiver reassembles by
(flow, seq). The op encoding::

    op      := u16 meta_len | meta json | u8 n_arrays
               | n_arrays * (u8 dtype_code | u32 nbytes | raw bytes)

Retransmission resends every fragment of the op; the flip-bit check on
the reassembled op (not per fragment) keeps side effects exactly-once.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Iterator

import numpy as np

PROTO_VERSION = 1
MAX_FRAME = 16 * 1024 * 1024
MTU_DEFAULT = 65536          # fragment payload bound (bytes)

KIND_HELLO = 1
KIND_OP = 2
KIND_ACK = 3
KIND_CTRL = 4

# op names ride in the op meta under "op"
OP_RESERVE = "reserve"
OP_RELEASE = "release"
OP_ADDTO = "addto"
OP_ADDTO_F32 = "addto_f32"
OP_READ = "read"
OP_CLEAR = "clear"
# ops whose replay must be suppressed by the flip bit; reads and the
# daemon-memoized reserve/release re-execute harmlessly on retransmit
SIDE_EFFECT_OPS = frozenset({OP_ADDTO, OP_ADDTO_F32, OP_CLEAR})

_DTYPES = (np.dtype(np.int32), np.dtype(np.int64), np.dtype(np.float32),
           np.dtype(np.float64), np.dtype(np.uint32))
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}

_OP_HDR = struct.Struct("!IIBHH")     # flow, seq, flip, frag, nfrags
_ACK_HDR = struct.Struct("!IIBBHH")   # flow, seq, ecn, applied, frag, nfrags


class ProtocolError(Exception):
    pass


def encode_op(op: str, meta: dict, arrays: list[np.ndarray]) -> bytes:
    head = dict(meta)
    head["op"] = op
    mb = json.dumps(head, separators=(",", ":")).encode()
    parts = [struct.pack("!H", len(mb)), mb, struct.pack("!B", len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(a)
        code = _DTYPE_CODE.get(a.dtype)
        if code is None:
            raise ProtocolError(f"unsupported wire dtype {a.dtype}")
        parts.append(struct.pack("!BI", code, a.nbytes))
        # buffer view, not tobytes(): join makes the only copy
        parts.append(memoryview(a).cast("B"))
    return b"".join(parts)


def decode_op(buf) -> tuple[str, dict, list[np.ndarray]]:
    (mlen,) = struct.unpack_from("!H", buf, 0)
    meta = json.loads(bytes(memoryview(buf)[2:2 + mlen]).decode())
    off = 2 + mlen
    (n,) = struct.unpack_from("!B", buf, off)
    off += 1
    arrays = []
    for _ in range(n):
        code, nbytes = struct.unpack_from("!BI", buf, off)
        off += 5
        dt = np.dtype(_DTYPES[code])
        # zero-copy view into the frame buffer
        arrays.append(np.frombuffer(buf, dt, count=nbytes // dt.itemsize,
                                    offset=off))
        off += nbytes
    return meta.pop("op"), meta, arrays


def fragment(blob: bytes, mtu: int) -> list[bytes]:
    """Split an encoded op/result into <= MTU payload chunks (at least
    one, so zero-payload ops still produce a frame)."""
    if len(blob) <= mtu:
        return [blob]
    return [blob[i:i + mtu] for i in range(0, len(blob), mtu)]


class Reassembler:
    """Per-(flow, seq) fragment buffers. Duplicate fragments (retransmit
    overlap) overwrite identically; a completed key hands back the blob
    and drops its buffer."""

    def __init__(self):
        self._bufs: dict[tuple[int, int], list[bytes | None]] = {}

    def add(self, flow: int, seq: int, frag: int, nfrags: int,
            payload: bytes) -> bytes | None:
        if nfrags <= 0 or frag >= nfrags:
            raise ProtocolError(f"bad fragment {frag}/{nfrags}")
        if nfrags == 1:
            return payload
        key = (flow, seq)
        buf = self._bufs.get(key)
        if buf is None or len(buf) != nfrags:
            buf = self._bufs[key] = [None] * nfrags
        buf[frag] = payload
        if any(p is None for p in buf):
            return None
        del self._bufs[key]
        return b"".join(buf)

    def drop_flow(self, flow: int) -> None:
        for key in [k for k in self._bufs if k[0] == flow]:
            del self._bufs[key]


# -- frame I/O ---------------------------------------------------------------

def pack_frame(body: bytes) -> bytes:
    if len(body) > MAX_FRAME:
        raise ProtocolError(f"frame body {len(body)} exceeds {MAX_FRAME}")
    return struct.pack("!I", len(body)) + body


def hello_frame(flow: int, w_max: int) -> bytes:
    body = json.dumps({"flow": flow, "w_max": w_max,
                       "proto": PROTO_VERSION}).encode()
    return pack_frame(bytes([KIND_HELLO]) + body)


def ctrl_frame(obj: dict) -> bytes:
    return pack_frame(bytes([KIND_CTRL]) +
                      json.dumps(obj, separators=(",", ":")).encode())


def op_frames(flow: int, seq: int, flip: int, blob: bytes,
              mtu: int) -> list[bytes]:
    frags = fragment(blob, mtu)
    return [pack_frame(bytes([KIND_OP]) +
                       _OP_HDR.pack(flow, seq, flip, i, len(frags)) + p)
            for i, p in enumerate(frags)]


def ack_frames(flow: int, seq: int, ecn: bool, applied: bool, blob: bytes,
               mtu: int) -> list[bytes]:
    frags = fragment(blob, mtu)
    return [pack_frame(bytes([KIND_ACK]) +
                       _ACK_HDR.pack(flow, seq, int(ecn), int(applied),
                                     i, len(frags)) + p)
            for i, p in enumerate(frags)]


def parse_body(body) -> tuple[int, dict]:
    """Parse one frame body into (kind, fields). OP/ACK payload bytes ride
    under ``"payload"`` as a zero-copy view; HELLO/CTRL decode their json
    inline."""
    kind = body[0]
    if kind == KIND_OP:
        flow, seq, flip, frag, nfrags = _OP_HDR.unpack_from(body, 1)
        return kind, {"flow": flow, "seq": seq, "flip": flip, "frag": frag,
                      "nfrags": nfrags,
                      "payload": memoryview(body)[1 + _OP_HDR.size:]}
    if kind == KIND_ACK:
        flow, seq, ecn, applied, frag, nfrags = _ACK_HDR.unpack_from(body, 1)
        return kind, {"flow": flow, "seq": seq, "ecn": bool(ecn),
                      "applied": bool(applied), "frag": frag,
                      "nfrags": nfrags,
                      "payload": memoryview(body)[1 + _ACK_HDR.size:]}
    if kind in (KIND_HELLO, KIND_CTRL):
        return kind, json.loads(bytes(memoryview(body)[1:]).decode())
    raise ProtocolError(f"unknown frame kind {kind}")


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return buf


def read_frame(sock: socket.socket) -> bytes:
    """One frame body off a blocking socket (raises ConnectionError on a
    clean or dirty close, socket.timeout on the socket's own timeout)."""
    (n,) = struct.unpack("!I", recv_exact(sock, 4))
    if n > MAX_FRAME:
        raise ProtocolError(f"frame body {n} exceeds {MAX_FRAME}")
    return recv_exact(sock, n)


def iter_frames(sock: socket.socket) -> Iterator[bytes]:
    while True:
        yield read_frame(sock)
