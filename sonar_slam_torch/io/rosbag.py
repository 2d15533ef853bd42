"""ROS1 rosbag (format 2.0) reader — no ROS installation required.

Counterpart of ``sonar_slam_tpu/io/rosbag.py``, with ``bag_to_streams``
returning the port's ``io.dataset.SensorStreams``. The reference's input is
a ROS1 bag of BlueROV sensor topics (its README and ``utils/topics.py``).
This module decodes those bags natively:

* the container format (records with key=value headers; chunked storage with
  none/bz2 compression; connection records) is parsed directly,
* messages are deserialized **generically** from the message-definition text
  every ROS1 bag embeds in its connection headers — a small IDL parser builds
  struct readers for any message type (standard or custom: sonar_oculus/
  OculusPing, rti_dvl/DVL, bar30_depth/Depth, kvh_gyro/gyro, ...), so no
  per-package Python message classes are needed.

`read_bag(path)` yields (topic, t, message-as-nested-dict) in time order per
chunk — the replacement for the reference's ``utils/io.py:130-154`` rosbag
generator. `bag_to_streams` maps the reference topics onto `SensorStreams` +
ping message dicts.

A minimal writer (`write_bag`) makes single-chunk bags (uncompressed, bz2 or
lz4) for round-trip tests.
"""

from __future__ import annotations

import bz2
import re
import struct
from dataclasses import dataclass, field
from typing import Any, Iterator

from .lz4 import compress_frame as lz4_compress
from .lz4 import decompress_frame as lz4_decompress

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        kv = buf[off : off + flen]
        off += flen
        k, _, v = kv.partition(b"=")
        fields[k] = v
    return fields


def _read_record(data: bytes, off: int):
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    header = _parse_header(data[off : off + hlen])
    off += hlen
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    payload = data[off : off + dlen]
    off += dlen
    return header, payload, off


# ----------------------------------------------------------------------
# message-definition-driven deserialization
# ----------------------------------------------------------------------

_PRIMITIVES = {
    "bool": ("<B", 1),
    "int8": ("<b", 1),
    "uint8": ("<B", 1),
    "byte": ("<b", 1),
    "char": ("<B", 1),
    "int16": ("<h", 2),
    "uint16": ("<H", 2),
    "int32": ("<i", 4),
    "uint32": ("<I", 4),
    "int64": ("<q", 8),
    "uint64": ("<Q", 8),
    "float32": ("<f", 4),
    "float64": ("<d", 8),
}

_NP_DTYPES = {
    "int8": np.int8, "uint8": np.uint8, "byte": np.int8, "char": np.uint8,
    "int16": np.int16, "uint16": np.uint16, "int32": np.int32,
    "uint32": np.uint32, "int64": np.int64, "uint64": np.uint64,
    "float32": np.float32, "float64": np.float64, "bool": np.uint8,
}

_FIELD_RE = re.compile(
    r"^\s*([\w/]+)\s*(\[(\d*)\])?\s+(\w+)\s*(=.*)?$"
)


@dataclass
class _MsgSpec:
    fields: list  # (name, type, array_len | None | -1 for variable)


class MessageType:
    """A deserializer compiled from a bag-embedded message definition."""

    def __init__(self, type_name: str, definition: str):
        self.type_name = type_name
        self.specs: dict[str, _MsgSpec] = {}
        self._parse_definition(type_name, definition)

    def _parse_definition(self, root: str, text: str) -> None:
        sections = re.split(r"^=+\s*$", text, flags=re.M)
        names = [root]
        for sec in sections[1:]:
            m = re.search(r"^MSG:\s*([\w/]+)\s*$", sec, flags=re.M)
            names.append(m.group(1) if m else "?")
        for name, sec in zip(names, sections):
            self.specs[name] = self._parse_section(sec)
            # also register the short name for intra-package references
            if "/" in name:
                self.specs.setdefault(name.split("/")[-1], self.specs[name])

    def _parse_section(self, text: str) -> _MsgSpec:
        fields = []
        for line in text.splitlines():
            line = line.split("#")[0].rstrip()
            if not line or line.startswith("MSG:"):
                continue
            m = _FIELD_RE.match(line)
            if not m:
                continue
            ftype, arr, arr_len, fname, const = m.groups()
            if const:  # constant declaration, not a serialized field
                continue
            if arr is None:
                fields.append((fname, ftype, None))
            elif arr_len:
                fields.append((fname, ftype, int(arr_len)))
            else:
                fields.append((fname, ftype, -1))
        return _MsgSpec(fields)

    # -- decoding ------------------------------------------------------

    def decode(self, data: bytes) -> dict[str, Any]:
        value, off = self._decode_struct(self.type_name, data, 0)
        return value

    def _resolve(self, ftype: str) -> str:
        if ftype in self.specs:
            return ftype
        # Header is special-cased in ROS serialization
        if ftype in ("Header", "std_msgs/Header"):
            return "std_msgs/Header"
        short = ftype.split("/")[-1]
        if short in self.specs:
            return short
        raise KeyError(f"unknown message type {ftype} in {self.type_name}")

    def _decode_struct(self, ftype: str, data: bytes, off: int):
        if ftype in ("Header", "std_msgs/Header") and ftype not in self.specs:
            # seq uint32, stamp time, frame_id string
            (seq,) = struct.unpack_from("<I", data, off)
            secs, nsecs = struct.unpack_from("<II", data, off + 4)
            off += 12
            (slen,) = struct.unpack_from("<I", data, off)
            off += 4
            frame = data[off : off + slen].decode(errors="replace")
            off += slen
            return {"seq": seq, "stamp": secs + nsecs * 1e-9,
                    "frame_id": frame}, off
        spec = self.specs[self._resolve(ftype)]
        out: dict[str, Any] = {}
        for name, t, arr in spec.fields:
            out[name], off = self._decode_field(t, arr, data, off)
        return out, off

    def _decode_field(self, t: str, arr, data: bytes, off: int):
        if arr is None:
            return self._decode_scalar(t, data, off)
        if arr == -1:
            (n,) = struct.unpack_from("<I", data, off)
            off += 4
        else:
            n = arr
        if t in _NP_DTYPES:
            dt = np.dtype(_NP_DTYPES[t]).newbyteorder("<")
            vals = np.frombuffer(data, dt, count=n, offset=off)
            return vals, off + n * dt.itemsize
        vals = []
        for _ in range(n):
            v, off = self._decode_scalar(t, data, off)
            vals.append(v)
        return vals, off

    def _decode_scalar(self, t: str, data: bytes, off: int):
        if t in _PRIMITIVES:
            fmt, size = _PRIMITIVES[t]
            (v,) = struct.unpack_from(fmt, data, off)
            if t == "bool":
                v = bool(v)
            return v, off + size
        if t == "string":
            (n,) = struct.unpack_from("<I", data, off)
            off += 4
            return data[off : off + n].decode(errors="replace"), off + n
        if t in ("time", "duration"):
            secs, nsecs = struct.unpack_from("<II" if t == "time" else "<ii",
                                             data, off)
            return secs + nsecs * 1e-9, off + 8
        return self._decode_struct(t, data, off)


@dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: MessageType


def read_bag(path: str, topics=None) -> Iterator[tuple[str, float, dict]]:
    """Yield (topic, time, decoded message dict) from a ROS1 v2.0 bag."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path} is not a ROS bag v2.0 file")
    off = len(MAGIC)
    connections: dict[int, Connection] = {}

    def handle_records(data: bytes):
        o = 0
        while o < len(data):
            header, payload, o = _read_record(data, o)
            op = header[b"op"][0]
            if op == OP_CONNECTION:
                (cid,) = struct.unpack("<I", header[b"conn"])
                topic = header[b"topic"].decode()
                ch = _parse_header(payload)
                mtype = ch.get(b"type", b"?").decode()
                mdef = ch.get(b"message_definition", b"").decode()
                connections[cid] = Connection(cid, topic, MessageType(mtype, mdef))
            elif op == OP_MSG:
                (cid,) = struct.unpack("<I", header[b"conn"])
                secs, nsecs = struct.unpack("<II", header[b"time"])
                t = secs + nsecs * 1e-9
                conn = connections.get(cid)
                if conn is None:
                    continue
                if topics is not None and conn.topic not in topics:
                    continue
                yield conn.topic, t, conn.msg_type.decode(payload)

    while off < len(blob):
        header, payload, off = _read_record(blob, off)
        op = header[b"op"][0]
        if op == OP_CHUNK:
            compression = header.get(b"compression", b"none")
            if compression == b"bz2":
                payload = bz2.decompress(payload)
            elif compression == b"lz4":
                payload = lz4_decompress(payload)
            elif compression not in (b"none",):
                raise NotImplementedError(
                    f"chunk compression {compression!r} unsupported"
                )
            yield from handle_records(payload)
        elif op in (OP_CONNECTION, OP_MSG):
            # unchunked bags store records at the top level; re-wrap the one
            # record so the same handler processes it
            yield from handle_records(_encode_record(header, payload))
        # other ops (index, chunk info, bag header) are skipped


# ----------------------------------------------------------------------
# minimal writer (tests only)
# ----------------------------------------------------------------------


def _encode_header(fields: dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        kv = k + b"=" + v
        out += struct.pack("<I", len(kv)) + kv
    return out


def _encode_record(header: dict[bytes, bytes], payload: bytes) -> bytes:
    h = _encode_header(header)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(payload)) + payload


def write_bag(path: str, connections: list[dict], messages: list[tuple],
              compression: str = "none", chunk_size: int | None = None):
    """Write a bag (``compression``: none | bz2 | lz4): one chunk, or with
    ``chunk_size`` a new chunk whenever one holds that many bytes, as
    ``rosbag record --chunksize`` does (768 kB by default). The connection
    records open the first chunk.

    connections: [{"id", "topic", "type", "definition"}]
    messages: [(conn_id, t_seconds, raw_payload_bytes)]
    """
    if compression not in ("none", "bz2", "lz4"):
        raise ValueError(f"unknown compression {compression!r}")
    chunks, records, size = [], [], 0
    for c in connections:
        conn_header = {
            b"op": bytes([OP_CONNECTION]),
            b"conn": struct.pack("<I", c["id"]),
            b"topic": c["topic"].encode(),
        }
        conn_payload = _encode_header(
            {
                b"topic": c["topic"].encode(),
                b"type": c["type"].encode(),
                b"md5sum": b"0" * 32,
                b"message_definition": c["definition"].encode(),
            }
        )
        records.append(_encode_record(conn_header, conn_payload))
        size += len(records[-1])
    for cid, t, payload in messages:
        if chunk_size is not None and size >= chunk_size:
            chunks.append(b"".join(records))
            records, size = [], 0
        secs = int(t)
        nsecs = int(round((t - secs) * 1e9))
        msg_header = {
            b"op": bytes([OP_MSG]),
            b"conn": struct.pack("<I", cid),
            b"time": struct.pack("<II", secs, nsecs),
        }
        records.append(_encode_record(msg_header, payload))
        size += len(records[-1])
    chunks.append(b"".join(records))

    with open(path, "wb") as f:
        f.write(MAGIC)
        bag_header = {
            b"op": bytes([OP_BAG_HEADER]),
            b"index_pos": struct.pack("<Q", 0),
            b"conn_count": struct.pack("<I", len(connections)),
            b"chunk_count": struct.pack("<I", len(chunks)),
        }
        # bag header record is conventionally padded to 4096 bytes
        rec = _encode_record(bag_header, b"")
        pad = 4096 - len(rec)
        bag_header[b"padding"] = b" " * max(pad - 12, 0)
        f.write(_encode_record(bag_header, b""))
        for chunk in chunks:
            raw_size = len(chunk)
            if compression == "bz2":
                chunk = bz2.compress(chunk)
            elif compression == "lz4":
                chunk = lz4_compress(chunk)
            chunk_header = {
                b"op": bytes([OP_CHUNK]),
                b"compression": compression.encode(),
                b"size": struct.pack("<I", raw_size),
            }
            f.write(_encode_record(chunk_header, chunk))


# ----------------------------------------------------------------------
# reference-topic ingestion
# ----------------------------------------------------------------------

# raw sensor topic names used by the BlueROV bags (reference utils/topics.py)
ROS_TOPICS = {
    "imu": "/vn100/imu/raw",
    "imu_mk2": "/vectornav/IMU",
    "dvl": "/rti/body_velocity/raw",
    "depth": "/bar30/depth/raw",
    "sonar": "/sonar_oculus_node/M750d/ping",
    "sonar_raw": "/sonar_oculus_node/ping",
    "sonar_vertical": "/sonar_oculus_node/M1200d/ping",
    "gyro": "/gyro",
}


def _quat_to_rpy(x, y, z, w):
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def bag_to_streams(path: str, imu_version: int = 1):
    """Decode a BlueROV bag into (SensorStreams, ping dicts).

    Returns (streams, pings) where ``pings`` is a list of decoded OculusPing
    message dicts with their bag timestamps attached under ``"_t"`` —
    image decoding (JPEG pings) is left to the caller since it may need
    cv2/PIL. Raises on missing topics rather than guessing.
    """
    from .dataset import SensorStreams

    imu_topic = ROS_TOPICS["imu" if imu_version == 1 else "imu_mk2"]
    wanted = {
        imu_topic, ROS_TOPICS["dvl"], ROS_TOPICS["depth"],
        ROS_TOPICS["sonar"], ROS_TOPICS["sonar_raw"], ROS_TOPICS["gyro"],
    }
    imu_t, imu_rpy = [], []
    dvl_t, dvl_v = [], []
    dep_t, dep = [], []
    gyr_t, gyr_d = [], []
    pings = []
    for topic, t, msg in read_bag(path, topics=wanted):
        if topic == imu_topic:
            q = msg["orientation"]
            imu_t.append(msg.get("header", {}).get("stamp", t))
            imu_rpy.append(_quat_to_rpy(q["x"], q["y"], q["z"], q["w"]))
        elif topic == ROS_TOPICS["dvl"]:
            v = msg["velocity"]
            dvl_t.append(msg.get("header", {}).get("stamp", t))
            dvl_v.append([v["x"], v["y"], v["z"]])
        elif topic == ROS_TOPICS["depth"]:
            dep_t.append(msg.get("header", {}).get("stamp", t))
            dep.append(msg.get("depth", 0.0))
        elif topic == ROS_TOPICS["gyro"]:
            gyr_t.append(msg.get("header", {}).get("stamp", t))
            gyr_d.append(list(msg.get("delta", [0.0, 0.0, 0.0])))
        else:  # sonar pings (compressed or raw)
            msg["_t"] = t
            msg["_topic"] = topic
            pings.append(msg)

    streams = SensorStreams(
        imu_time=np.asarray(imu_t, np.float64),
        imu_rpy=np.asarray(imu_rpy, np.float32),
        dvl_time=np.asarray(dvl_t, np.float64),
        dvl_vel=np.asarray(dvl_v, np.float32),
        depth_time=np.asarray(dep_t, np.float64),
        depth=np.asarray(dep, np.float32),
        gyro_time=np.asarray(gyr_t, np.float64) if gyr_t else None,
        gyro_yaw=None if not gyr_t else np.cumsum(
            np.asarray(gyr_d, np.float64)[:, 0]
        ).astype(np.float32),
    )
    return streams, pings
