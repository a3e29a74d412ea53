"""Minimal TensorBoard event-file writer (no TensorFlow dependency); a
copy of honerf_tpu.utils.tbevents, which the port cannot import without
JAX.

The reference logs training scalars through
`torch.utils.tensorboard.SummaryWriter` (exp_runner.py:128, :244-251);
this module writes the same `events.out.tfevents.*` files so a TensorBoard
instance pointed at the experiment dir works unchanged, while the primary
metrics stream stays the JSONL log (honerf_torch/train/runner.py).

Implements just enough of the two formats involved:
  * TFRecord framing: [len u64][masked crc32c(len) u32][payload]
    [masked crc32c(payload) u32];
  * protobuf wire encoding of tensorflow.Event
    (wall_time=1 double, step=2 int64, file_version=3 string,
     summary=5 message) and Summary/Summary.Value
    (tag=1 string, simple_value=2 float).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterable, List, Tuple

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected polynomial 0x82F63B78) — table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire helpers
# ---------------------------------------------------------------------------


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


def _field_double(num: int, v: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(v)


def _field_bytes(num: int, v: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(v)) + v


def _field_float(num: int, v: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", v)


def _encode_event(wall_time: float, step: int | None = None,
                  file_version: str | None = None,
                  scalars: Dict[str, float] | None = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(
                1,
                _field_bytes(1, tag.encode()) + _field_float(2, float(v)),
            )
            for tag, v in scalars.items()
        )
        msg += _field_bytes(5, summary)
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class TBEventWriter:
    """Append-only scalar writer compatible with TensorBoard.

    Usage:
        w = TBEventWriter(logdir)
        w.add_scalars(step, {"Loss/loss": 0.5, "Statistics/psnr": 31.0})
        w.flush()
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._f.write(_record(_encode_event(time.time(),
                                            file_version="brain.Event:2")))

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    wall_time: float | None = None) -> None:
        self._f.write(_record(_encode_event(
            wall_time if wall_time is not None else time.time(),
            step=step, scalars=scalars,
        )))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# reader (for tests and offline inspection; TensorBoard itself is the
# intended consumer)
# ---------------------------------------------------------------------------


def read_events(path: str) -> List[Tuple[int, Dict[str, float]]]:
    """Decode (step, {tag: value}) scalar events from an event file,
    verifying TFRecord crcs."""
    out: List[Tuple[int, Dict[str, float]]] = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (ln,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        assert hcrc == _masked_crc(data[off:off + 8]), "header crc mismatch"
        payload = data[off + 12:off + 12 + ln]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + ln)
        assert pcrc == _masked_crc(payload), "payload crc mismatch"
        off += 12 + ln + 4
        step, scalars = 0, {}
        for num, wire, val in _iter_fields(payload):
            if num == 2 and wire == 0:
                step = val
            elif num == 5 and wire == 2:
                for vnum, vwire, vval in _iter_fields(val):
                    if vnum == 1 and vwire == 2:
                        tag, sv = None, None
                        for inum, iwire, ival in _iter_fields(vval):
                            if inum == 1 and iwire == 2:
                                tag = ival.decode()
                            elif inum == 2 and iwire == 5:
                                (sv,) = struct.unpack("<f", ival)
                        if tag is not None and sv is not None:
                            scalars[tag] = sv
        if scalars:
            out.append((step, scalars))
    return out


def _iter_fields(buf: bytes) -> Iterable[Tuple[int, int, object]]:
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
        elif wire == 1:
            val, off = buf[off:off + 8], off + 8
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            val, off = buf[off:off + ln], off + ln
        elif wire == 5:
            val, off = buf[off:off + 4], off + 4
        else:  # pragma: no cover - unused wire types
            raise ValueError(f"unsupported wire type {wire}")
        yield num, wire, val


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7
