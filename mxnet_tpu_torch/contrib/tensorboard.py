"""TensorBoard logging (reference: python/mxnet/contrib/tensorboard.py).

PyTorch counterpart of ``mxnet_tpu/contrib/tensorboard.py``, the same
writer, so the two packages' event files are the same bytes at the
same clock.  The reference delegates to the ``tensorboard`` package's
SummaryWriter; this one needs no package: TFRecord framing (length +
masked CRC32C) around hand-encoded Event / Summary protobuf messages,
for scalars, all that the reference's LogMetricsCallback writes.
Standard TensorBoard reads the files.
"""
from __future__ import annotations

import os
import struct
import time


# -- crc32c (software, slice-free reference implementation) ----------------
_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding ---------------------------------------
def _varint(n: int) -> bytes:
    # negative int64 → two's-complement ten-byte encoding (protobuf wire)
    n &= 0xFFFFFFFFFFFFFFFF
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f_double(num, v):
    return _field(num, 1) + struct.pack("<d", v)


def _f_float(num, v):
    return _field(num, 5) + struct.pack("<f", v)


def _f_varint(num, v):
    return _field(num, 0) + _varint(v)


def _f_bytes(num, v: bytes):
    return _field(num, 2) + _varint(len(v)) + v


def _scalar_event(tag: str, value: float, step: int) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }
    val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    summary = _f_bytes(1, val)                    # Summary{ value=1 }
    # Event{ wall_time=1, step=2, summary=5 }
    return (_f_double(1, time.time()) + _f_varint(2, int(step))
            + _f_bytes(5, summary))


class SummaryWriter:
    """Scalar-only TensorBoard event writer (tfevents format)."""

    _counter = 0

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        # pid + per-process counter: concurrent writers in one logdir must
        # never collide (TF writers disambiguate the same way)
        SummaryWriter._counter += 1
        fname = "events.out.tfevents.%d.%d.%d.mxnet_tpu" % (
            int(time.time()), os.getpid(), SummaryWriter._counter)
        self._f = open(os.path.join(logdir, fname), "wb")
        self._write_event(_f_double(1, time.time())
                          + _f_bytes(3, b"brain.Event:2"))  # file_version

    def _write_event(self, payload: bytes):
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag, value, global_step=0):
        self._write_event(_scalar_event(tag, value, global_step))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class LogMetricsCallback:
    """Batch-end callback streaming eval metrics to TensorBoard
    (reference: contrib/tensorboard.py LogMetricsCallback)."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = SummaryWriter(logging_dir)

    def __call__(self, param):
        self.step += 1
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = '%s-%s' % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
        self.summary_writer.flush()
