"""TensorBoard scalar events without TensorFlow (the port's copy of
``gansformer_tpu/utils/tensorboard.py``): event files are TFRecord-framed
``tensorflow.Event`` protos, and the framing and proto emitters are the
port's TFRecord writer's.

Wire format (the fields the scalar dashboard reads): Event {wall_time
double=1, step int64=2, file_version string=3, summary Summary=5},
Summary {repeated Value value=1}, Value {tag string=1, simple_value
float=2}.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

from gansformer_tpu_torch.data.tfrecord_writer import (
    _len_delim, _varint, write_record)


def _double_field(field: int, value: float) -> bytes:
    return _varint(field << 3 | 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _varint(field << 3 | 5) + struct.pack("<f", value)


def _int_field(field: int, value: int) -> bytes:
    return _varint(field << 3 | 0) + _varint(value)


def _scalar_value(tag: str, value: float) -> bytes:
    body = _len_delim(1, tag.encode("utf-8")) + _float_field(2, float(value))
    return _len_delim(1, body)            # Summary.value = 1


def encode_event(wall_time: float, step: Optional[int] = None,
                 scalars: Optional[Dict[str, float]] = None,
                 file_version: Optional[str] = None) -> bytes:
    ev = _double_field(1, wall_time)
    if step is not None:
        ev += _int_field(2, int(step))
    if file_version is not None:
        ev += _len_delim(3, file_version.encode("utf-8"))
    if scalars:
        summary = b"".join(_scalar_value(t, v) for t, v in scalars.items())
        ev += _len_delim(5, summary)
    return ev


class EventWriter:
    """Append-only scalar event file, TensorBoard-readable.

    One instance per run dir; ``scalars({'Loss/G': …}, step)`` per tick —
    the same names the reference's autosummary emits, so existing
    TensorBoard habits (regex ``Loss/.*``) carry over.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        # TensorBoard ignores files without the version preamble.
        write_record(self._f, encode_event(time.time(),
                                           file_version="brain.Event:2"))
        self._f.flush()

    def scalars(self, values: Dict[str, float], step: int) -> None:
        clean = {k: float(v) for k, v in values.items()
                 if isinstance(v, (int, float))}
        if not clean:
            return
        write_record(self._f, encode_event(time.time(), step=step,
                                           scalars=clean))
        self._f.flush()

    def close(self) -> None:
        self._f.close()
