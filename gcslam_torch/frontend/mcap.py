"""Minimal MCAP reader (the port's own copy of the JAX package's
frontend/mcap.py): rosbag2's other storage format (the sqlite reader
covers .db3). Parses the sequential record stream — schemas, channels,
messages, and chunks (uncompressed or zstd; lz4 fails fast with a clear
error) — and returns the same topic->[(stamp, cdr_bytes)] mapping
rosbag.read_bag_messages produces, so load_bag works off either container.

MCAP spec (mcap.dev): magic \\x89MCAP0\\r\\n, then records of
(opcode u8, length u64le, payload); strings are u32-prefixed UTF-8.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_FOOTER = 0x02
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_CHUNK = 0x06
OP_DATA_END = 0x0F


def _u32str(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    s = buf[off + 4 : off + 4 + n].decode("utf-8", "replace")
    return s, off + 4 + n


def _iter_records(buf: bytes, off: int, end: int):
    while off + 9 <= end:
        op = buf[off]
        (length,) = struct.unpack_from("<Q", buf, off + 1)
        payload_start = off + 9
        yield op, payload_start, payload_start + int(length)
        off = payload_start + int(length)


def _decompress_chunk(compression: str, data: bytes, out_size: int) -> bytes:
    if compression in ("", "none"):
        return data
    if compression == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data, max_output_size=out_size)
    if compression == "lz4":
        try:
            import lz4.frame  # type: ignore

            return lz4.frame.decompress(data)
        except ImportError:
            raise ValueError(
                "mcap chunk uses lz4 compression and no lz4 module is "
                "available; re-record with zstd/none or convert to .db3"
            )
    raise ValueError(f"unsupported mcap chunk compression {compression!r}")


def read_mcap_messages(path: str) -> Dict[str, List[Tuple[float, bytes]]]:
    """topic -> [(log_time_sec, raw_cdr)] sorted by time, plus a
    '__types__' entry mapping topic -> message type name (same contract as
    rosbag.read_bag_messages)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[: len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: not an MCAP file")

    schemas: Dict[int, str] = {}  # schema_id -> type name
    channels: Dict[int, Tuple[str, int]] = {}  # channel_id -> (topic, schema_id)
    out: Dict[str, List[Tuple[float, bytes]]] = {}

    def handle(op: int, s: int, e: int):
        if op == OP_SCHEMA:
            (sid,) = struct.unpack_from("<H", buf, s)
            name, _ = _u32str(buf, s + 2)
            schemas[sid] = name
        elif op == OP_CHANNEL:
            cid, sid = struct.unpack_from("<HH", buf, s)
            topic, _ = _u32str(buf, s + 4)
            channels[cid] = (topic, sid)
            out.setdefault(topic, [])
        elif op == OP_MESSAGE:
            (cid,) = struct.unpack_from("<H", buf, s)
            (log_time,) = struct.unpack_from("<Q", buf, s + 6)
            topic, _sid = channels.get(cid, (None, 0))
            if topic is not None:
                out[topic].append((log_time * 1e-9, bytes(buf[s + 22 : e])))
        elif op == OP_CHUNK:
            off = s + 8 + 8  # skip message_start/end_time
            (unc_size,) = struct.unpack_from("<Q", buf, off)
            off += 8 + 4  # skip uncompressed_crc
            compression, off = _u32str(buf, off)
            (rec_len,) = struct.unpack_from("<Q", buf, off)
            off += 8
            inner = _decompress_chunk(
                compression, buf[off : off + int(rec_len)], int(unc_size)
            )
            nonlocal_buf = inner  # nested records live in their own buffer
            for op2, s2, e2 in _iter_records(nonlocal_buf, 0, len(nonlocal_buf)):
                handle_nested(op2, nonlocal_buf, s2, e2)

    def handle_nested(op: int, nbuf: bytes, s: int, e: int):
        if op == OP_SCHEMA:
            (sid,) = struct.unpack_from("<H", nbuf, s)
            (n,) = struct.unpack_from("<I", nbuf, s + 2)
            schemas[sid] = nbuf[s + 6 : s + 6 + n].decode("utf-8", "replace")
        elif op == OP_CHANNEL:
            cid, sid = struct.unpack_from("<HH", nbuf, s)
            (n,) = struct.unpack_from("<I", nbuf, s + 4)
            topic = nbuf[s + 8 : s + 8 + n].decode("utf-8", "replace")
            channels[cid] = (topic, sid)
            out.setdefault(topic, [])
        elif op == OP_MESSAGE:
            (cid,) = struct.unpack_from("<H", nbuf, s)
            (log_time,) = struct.unpack_from("<Q", nbuf, s + 6)
            topic, _sid = channels.get(cid, (None, 0))
            if topic is not None:
                out[topic].append((log_time * 1e-9, bytes(nbuf[s + 22 : e])))

    for op, s, e in _iter_records(buf, len(MAGIC), len(buf)):
        if op in (OP_FOOTER, OP_DATA_END):
            break
        handle(op, s, e)

    for topic in out:
        out[topic].sort(key=lambda x: x[0])
    out["__types__"] = {  # type: ignore
        topic: schemas.get(sid, "") for topic, sid in
        {t: sid for t, sid in channels.values()}.items()
    }
    return out


# ---------------------------------------------------------------------------
# Writer (tests synthesize valid mcap bags; uncompressed, no chunking)
# ---------------------------------------------------------------------------


class McapWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        self._record(OP_HEADER, self._str("") + self._str("gcslam_torch"))
        self._schema_ids: Dict[str, int] = {}
        self._channel_ids: Dict[str, int] = {}

    def _str(self, s: str) -> bytes:
        b = s.encode()
        return struct.pack("<I", len(b)) + b

    def _record(self, op: int, payload: bytes):
        self.f.write(struct.pack("<BQ", op, len(payload)) + payload)

    def add_channel(self, topic: str, type_name: str) -> int:
        if topic in self._channel_ids:
            return self._channel_ids[topic]
        sid = len(self._schema_ids) + 1
        self._schema_ids[type_name] = sid
        self._record(OP_SCHEMA, struct.pack("<H", sid) + self._str(type_name)
                     + self._str("ros2msg") + struct.pack("<I", 0))
        cid = len(self._channel_ids) + 1
        self._channel_ids[topic] = cid
        self._record(OP_CHANNEL, struct.pack("<HH", cid, sid) + self._str(topic)
                     + self._str("cdr") + struct.pack("<I", 0))
        return cid

    def write_message(self, topic: str, log_time_sec: float, data: bytes):
        cid = self._channel_ids[topic]
        t_ns = int(log_time_sec * 1e9)
        self._record(OP_MESSAGE, struct.pack("<HIQQ", cid, 0, t_ns, t_ns) + data)

    def close(self):
        self._record(OP_DATA_END, struct.pack("<I", 0))
        self._record(OP_FOOTER, struct.pack("<QQI", 0, 0, 0))
        self.f.write(MAGIC)
        self.f.close()
