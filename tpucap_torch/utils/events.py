"""TensorBoard event files, written and read with the standard library.

An event file is a sequence of TFRecords: the data's length (u64 little
endian), the masked CRC-32C of those 8 bytes, the data, the masked CRC-32C
of the data. Each record's data is an ``Event`` protobuf. The first holds
``file_version: "brain.Event:2"``; each scalar is the form TF2's
``tf.summary.scalar`` writes: a ``Summary.Value`` with the tag, a 0-d
``DT_FLOAT`` tensor (its 4 bytes in ``tensor_content``) and ``scalars``
plugin metadata. The protobuf fields are encoded by hand here (field
numbers from TensorFlow's ``event.proto``, ``summary.proto`` and
``tensor.proto``); TensorBoard reads the files as its own.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of TFRecord framing."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # negative int64s as protobuf writes them
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    key = _varint((num << 3) | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def _event(wall_time: float, *, step: int | None = None, body: bytes = b"") -> bytes:
    out = _field(1, 1, struct.pack("<d", wall_time))
    if step:
        out += _field(2, 0, _varint(step))
    return out + body


def scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    """One ``Event`` holding one TF2 scalar summary."""
    tensor = (
        _field(1, 0, _varint(1))  # dtype DT_FLOAT
        + _field(2, 2, b"")  # tensor_shape: a scalar
        + _field(4, 2, struct.pack("<f", value))  # tensor_content
    )
    metadata = _field(1, 2, _field(1, 2, b"scalars"))  # plugin_data.plugin_name
    value_msg = _field(1, 2, tag.encode()) + _field(8, 2, tensor) + _field(9, 2, metadata)
    return _event(wall_time, step=step, body=_field(5, 2, _field(1, 2, value_msg)))


def record(data: bytes) -> bytes:
    """TFRecord framing of one record."""
    head = struct.pack("<Q", len(data))
    return head + struct.pack("<I", masked_crc(head)) + data + struct.pack("<I", masked_crc(data))


class EventFileWriter:
    """Appends scalar events to a new ``events.out.tfevents.*`` file in
    ``logdir``, flushing after each record."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        stem = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}"
        n = 0
        while True:  # a new file, whatever else writes into logdir
            self.path = os.path.join(str(logdir), f"{stem}.{n}.v2")
            try:
                self._f = open(self.path, "xb")
                break
            except FileExistsError:
                n += 1
        version = _field(3, 2, b"brain.Event:2") + _field(10, 2, _field(1, 2, b"tpucap_torch"))
        self._write(_event(time.time(), body=version))

    def _write(self, data: bytes) -> None:
        self._f.write(record(data))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(scalar_event(tag, float(value), int(step), time.time()))

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# -- reading ---------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: an int for
    varints, bytes for the rest."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, wire, val


def read_records(path) -> list[bytes]:
    """The records of one TFRecord file, both checksums verified."""
    data = Path(path).read_bytes()
    out, i = [], 0
    while i < len(data):
        head = data[i:i + 8]
        if len(data) < i + 12 or struct.unpack("<I", data[i + 8:i + 12])[0] != masked_crc(head):
            raise ValueError(f"{path}: bad record header at byte {i}")
        (n,) = struct.unpack("<Q", head)
        body = data[i + 12:i + 12 + n]
        if len(data) < i + 16 + n or struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] != masked_crc(body):
            raise ValueError(f"{path}: bad record data at byte {i}")
        out.append(body)
        i += 16 + n
    return out


def _scalar_value(value_msg: bytes) -> tuple[str, float] | None:
    tag, val = None, None
    for num, _, v in _fields(value_msg):
        if num == 1:
            tag = v.decode()
        elif num == 2:  # simple_value
            val = struct.unpack("<f", v)[0]
        elif num == 8:  # tensor: tensor_content or float_val (packed or not)
            for tnum, _, tv in _fields(v):
                if tnum in (4, 5):
                    val = struct.unpack("<f", tv[:4])[0]
    return None if tag is None or val is None else (tag, val)


def read_scalars(path) -> list[tuple[str, int, float]]:
    """[(tag, step, value)] of every scalar in an event file, or in every
    ``*tfevents*`` file of a directory (by name), in file order."""
    path = Path(path)
    files = sorted(path.glob("*tfevents*")) if path.is_dir() else [path]
    out = []
    for f in files:
        for rec in read_records(f):
            step, values = 0, []
            for num, _, v in _fields(rec):
                if num == 2:
                    step = v - (1 << 64) if v >= 1 << 63 else v
                elif num == 5:  # summary: its values
                    for n, _, sv in _fields(v):
                        if n == 1 and (scalar := _scalar_value(sv)):
                            values.append(scalar)
            out += [(tag, step, val) for tag, val in values]
    return out
