"""RecordIO: binary record files, pack and unpack.

PyTorch counterpart of ``mxnet_tpu/recordio.py`` (reference:
python/mxnet/recordio.py over dmlc-core's record framing).  The on-disk
format is the JAX package's byte for byte, so a file written by either
package reads in the other: each record is

    [kMagic:u32][lrec:u32][data...][pad to 4 bytes]

where lrec's upper 3 bits are the continuation flag (0 whole, 1 start,
2 middle, 3 end: the writer splits a payload at every embedded kMagic)
and its lower 29 bits the chunk's length.

``pack_img`` of a numpy image encodes through PIL, as the JAX package
does (the same bytes for the same input); of a CUDA tensor it encodes on
the card through nvJPEG (baseline, 4:2:0, the quality given).
``unpack_img`` decodes through PIL into a numpy array in a CPU context,
and through nvJPEG into an NDArray on the card in a GPU context (the
default).
"""
from __future__ import annotations

import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack('<I', _MAGIC)


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(rec):
    return rec >> 29, rec & ((1 << 29) - 1)


class MXRecordIO:
    """Sequential .rec reader and writer (reference: recordio.py:28)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        if self.flag == 'w':
            self.handle = open(self.uri, 'wb')
            self.writable = True
        elif self.flag == 'r':
            self.handle = open(self.uri, 'rb')
            self.writable = False
        else:
            raise MXNetError(f"Invalid flag {self.flag!r}")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  interpreter teardown
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d['handle'] = None
        is_open = d.pop('is_open', False)
        d['_was_open'] = is_open
        if is_open:
            d['_pos'] = self.tell() if not self.writable else None
        return d

    def __setstate__(self, d):
        was_open = d.pop('_was_open', False)
        pos = d.pop('_pos', None)
        self.__dict__.update(d)
        self.is_open = False
        if was_open:
            self.open()
            if pos is not None:
                # the byte position: an indexed reader's seek() takes a
                # key (the JAX package calls that one and raises KeyError)
                MXRecordIO.seek(self, pos)

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        """Write one record, split at embedded magics so that readers
        rejoin it (dmlc-core RecordIOWriter::WriteRecord)."""
        assert self.writable
        pieces = []
        start = 0
        while True:
            idx = buf.find(_MAGIC_BYTES, start)
            if idx == -1:
                pieces.append(buf[start:])
                break
            pieces.append(buf[start:idx])
            start = idx + 4
        n = len(pieces)
        for i, piece in enumerate(pieces):
            if n == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == n - 1:
                cflag = 3
            else:
                cflag = 2
            self.handle.write(_MAGIC_BYTES)
            self.handle.write(struct.pack('<I',
                                          _encode_lrec(cflag, len(piece))))
            self.handle.write(piece)
            pad = (4 - len(piece) % 4) % 4
            if pad:
                self.handle.write(b'\x00' * pad)

    def read(self):
        """The next record with its continuations rejoined, or None at the
        end (dmlc-core RecordIOReader::NextRecord)."""
        assert not self.writable
        out = b''
        expect_cont = False
        while True:
            head = self.handle.read(4)
            if len(head) < 4:
                return None if not out else out
            (magic,) = struct.unpack('<I', head)
            if magic != _MAGIC:
                raise MXNetError("invalid record magic; file corrupt?")
            (lrec,) = struct.unpack('<I', self.handle.read(4))
            cflag, length = _decode_lrec(lrec)
            data = self.handle.read(length)
            pad = (4 - length % 4) % 4
            if pad:
                self.handle.read(pad)
            if cflag == 0:
                assert not expect_cont
                return data
            if cflag == 1:
                assert not expect_cont
                out = data
                expect_cont = True
            elif cflag == 2:
                assert expect_cont
                out += _MAGIC_BYTES + data
            else:
                assert expect_cont
                out += _MAGIC_BYTES + data
                return out

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        assert not self.writable
        self.handle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Random access through a .idx file (reference: recordio.py:91)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, 'w')
        else:
            self.fidx = None
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split('\t')
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None and not self.fidx.closed:
            self.fidx.close()

    def __getstate__(self):
        d = super().__getstate__()
        d['fidx'] = None
        return d

    def seek(self, idx):
        """Seek to the record with key ``idx``."""
        assert not self.writable
        super().seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.handle.tell()
        self.fidx.write(f'{key}\t{pos}\n')
        self.idx[key] = pos
        self.keys.append(key)
        self.write(buf)


# image record header (reference: recordio.py IRHeader, pack, unpack)
IRHeader = namedtuple('HEADER', ['flag', 'label', 'id', 'id2'])
_IR_FORMAT = '=IfQQ'
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Header and raw bytes as one record payload (reference:
    recordio.py:214); a label that is not a scalar is stored as
    ``flag`` float32 values after the header."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float, np.floating, np.integer)):
        hdr = header._replace(flag=0)
        return struct.pack(_IR_FORMAT, *hdr) + s
    label = np.asarray(header.label, dtype=np.float32)
    hdr = header._replace(flag=label.size, label=0)
    return struct.pack(_IR_FORMAT, *hdr) + label.tobytes() + s


def unpack(s):
    """(header, payload) of a record (reference: recordio.py:240)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """(header, image) of an image record (reference: recordio.py:262).
    In a CPU context the image is a numpy HWC uint8 array decoded by PIL,
    as in the JAX package; in a GPU context (the default) an NDArray on
    the card decoded by nvJPEG."""
    from .context import current_context
    from .ndarray import NDArray
    header, s = unpack(s)
    flag = 1 if iscolor != 0 else 0
    ctx = current_context()
    if ctx.device_type == "gpu":
        from .image import nvjpeg
        return header, NDArray(nvjpeg.decode_one(s, 3 if flag else 1,
                                                 ctx.torch_device()))
    from .image import image
    return header, image.imdecode(s, flag, to_ndarray=False)


def pack_img(header, img, quality=95, img_fmt='.jpg'):
    """An image as a record payload (reference: recordio.py:288).  A
    numpy array (or anything but a CUDA tensor) is encoded by PIL, as the
    JAX package encodes it; a CUDA tensor or NDArray (HWC uint8, 3
    channels) is encoded on the card by nvJPEG as a baseline JPEG with
    4:2:0 chroma at ``quality``."""
    import torch
    from .ndarray import NDArray
    t = img._data if isinstance(img, NDArray) else img
    if isinstance(t, torch.Tensor) and t.is_cuda:
        if img_fmt.lower() not in ('.jpg', '.jpeg'):
            raise MXNetError(f"pack_img: the card encodes JPEG only, not "
                             f"{img_fmt}")
        from .image import nvjpeg
        return pack(header, nvjpeg.encode(t, quality))
    import io as _io
    from PIL import Image
    if isinstance(t, torch.Tensor):
        t = t.numpy()
    arr = np.asarray(t, dtype=np.uint8)
    pil = Image.fromarray(arr)
    buf = _io.BytesIO()
    fmt = 'JPEG' if img_fmt.lower() in ('.jpg', '.jpeg') else 'PNG'
    if fmt == 'JPEG':
        pil.save(buf, fmt, quality=quality)
    else:
        pil.save(buf, fmt)
    return pack(header, buf.getvalue())
