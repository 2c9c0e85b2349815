"""Pure-Python TensorBoard event-file writer — no TensorFlow dependency
(the port's own copy of ``embeddingnet_tpu/utils/tb_writer.py``).

The reference's TensorBoard logging rides a Keras callback
(``tools/train.py:97-98``), which drags the whole TF runtime in as a
logging dependency. A ``tfevents`` file is just a TFRecord stream of
``Event`` protos; scalars need three tiny messages (Event, Summary,
Summary.Value), so this hand-encodes the protobuf wire format and the
TFRecord framing (length + masked CRC32C) directly. Output is verified
against TensorFlow's own ``summary_iterator`` in
``tests/test_tb_writer.py``.
"""

from __future__ import annotations

import os
import struct
import time


def _make_crc32c_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _make_crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _scalar_event(wall_time: float, step: int, tag: str,
                  value: float) -> bytes:
    # Summary.Value { tag = 1 (string); simple_value = 2 (float) }
    sval = _bytes_field(1, tag.encode()) + _float_field(2, value)
    # Summary { value = 1 (repeated message) }
    summary = _bytes_field(1, sval)
    # Event { wall_time = 1 (double); step = 2 (int64);
    #         summary = 5 (message) }
    return (_double_field(1, wall_time) + _int_field(2, step)
            + _bytes_field(5, summary))


def _version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1; file_version = 3 (string) }
    return _double_field(1, wall_time) + _bytes_field(
        3, b"brain.Event:2")


class TBEventWriter:
    """Append-mode scalar writer producing standard ``tfevents`` files."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{os.uname().nodename}.{os.getpid()}{filename_suffix}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write_record(_version_event(time.time()))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(
            _scalar_event(time.time(), int(step), tag, float(value)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
