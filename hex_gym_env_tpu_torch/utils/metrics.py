"""Host-side metrics sinks (a copy of the JAX package's ``utils/metrics.py``,
which is pure Python).

The reference logs through SB3's TensorBoard writer (``tensorboard_log=
"log/"``, custom scalars ``eval/score`` etc., ``EvaluationCallback.py:41,
50-51``).  Here metrics leave the device once per learner iteration as a
small dict of scalars and are written to:

- a JSONL file (always; trivially parseable, no dependencies), and
- a TensorBoard event file via a minimal self-contained encoder of the
  ``Event``/``Summary`` protobuf wire format (no tensorflow/tensorboard
  package in the image), so the reference's `tensorboard --logdir log/`
  workflow keeps working.
"""

from __future__ import annotations

import json
import os
import struct as pystruct
import time
from typing import Mapping


def _varint(value: int) -> bytes:
    out = b""
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out += bytes([bits | 0x80])
        else:
            return out + bytes([bits])


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _double(field: int, value: float) -> bytes:
    return _tag(field, 1) + pystruct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _tag(field, 5) + pystruct.pack("<f", value)


def _encode_scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value { tag = 1 (string), simple_value = 2 (float) }
    sv = _len_delim(1, tag.encode()) + _float(2, value)
    # Summary { value = 1 (repeated message) }
    summary = _len_delim(1, sv)
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 }
    event = _double(1, wall_time) + _tag(2, 0) + _varint(step) + _len_delim(5, summary)
    return event


_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            _CRC_TABLE.append(crc)
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) % (1 << 32) + 0xA282EAD8 & 0xFFFFFFFF


class TensorBoardWriter:
    """Minimal TFRecord event-file writer (scalars only)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{os.uname().nodename}"
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write_event(
            _double(1, time.time()) + _len_delim(3, b"brain.Event:2")
        )  # file_version header

    def _write_event(self, event: bytes) -> None:
        header = pystruct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(pystruct.pack("<I", _masked_crc(header)))
        self._f.write(event)
        self._f.write(pystruct.pack("<I", _masked_crc(event)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write_event(_encode_scalar_event(tag, float(value), int(step), time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MetricsLogger:
    """JSONL + TensorBoard sink for per-iteration scalar dicts."""

    def __init__(self, logdir: str, run_name: str, tensorboard: bool = True):
        self.dir = os.path.join(logdir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = TensorBoardWriter(self.dir) if tensorboard else None

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.scalar(k, float(v), step)
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb:
            self._tb.close()
