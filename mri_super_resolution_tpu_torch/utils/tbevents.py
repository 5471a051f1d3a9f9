"""Minimal TensorBoard event-file writer — no TF/torch dependency.

Copy of ``mri_super_resolution_tpu/utils/tbevents.py`` (pure Python), so
the port imports nothing of the JAX package; ``tests/test_torch_trainer.py``
holds its records byte-equal to that writer's.

Reference parity: the MISR Trainer logs Loss/PSNR train+test scalars via
``tf.summary.create_file_writer`` + ``tf.summary.scalar``
(multi-image-super-resolution/utils/training.py:128-129,157-178). This module
reimplements just enough of the two underlying formats from scratch:

1. **TFRecord framing**: each record is
   ``uint64-LE length | masked-crc32c(length) | payload | masked-crc32c(payload)``
   with CRC32-Castagnoli and TF's rotate+offset masking.
2. **Event protobuf wire encoding** (hand-rolled; the messages involved are
   tiny): ``Event{wall_time=1 double, step=2 int64, file_version=3 string,
   summary=5 Summary}``, ``Summary{value=1 repeated Value}``,
   ``Value{tag=1 string, simple_value=2 float}``.

Files written here load in stock TensorBoard (validated in
tests/test_tbevents.py against tensorboard's own EventAccumulator).
"""
from __future__ import annotations

import os
import socket
import struct
import time


def _make_crc_table() -> list[int]:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- protobuf wire encoding (varint + the three wire types we need) --------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _double_field(field: int, v: float) -> bytes:
    return _varint((field << 3) | 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _varint((field << 3) | 5) + struct.pack("<f", v)


def _int64_field(field: int, n: int) -> bytes:
    if n < 0:  # proto int64: negative values use the 10-byte two's complement
        n += 1 << 64
    return _varint(field << 3) + _varint(n)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    value_msg = _len_field(1, tag.encode("utf-8")) + _float_field(2, float(value))
    summary = _len_field(1, value_msg)
    return _double_field(1, wall_time) + _int64_field(2, int(step)) + _len_field(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _double_field(1, wall_time) + _len_field(3, b"brain.Event:2")


class EventWriter:
    """Append-only scalar writer for one TensorBoard run directory.

    Usage::

        with EventWriter(log_dir) as w:
            w.add_scalar("Loss", loss, step)
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}{filename_suffix}"
        )
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int, wall_time: float | None = None) -> None:
        self._write_record(
            _scalar_event(tag, value, step, time.time() if wall_time is None else wall_time)
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
