"""RecordIO files (counterpart of mxnet_tpu/recordio.py), byte for byte
the dmlc format the JAX package reads and writes: each record is

  [magic:4B][lrec:4B][payload][pad to 4B]

where lrec's upper 3 bits are a continuation flag (0: a whole record) and
the lower 29 bits the payload length; :func:`pack` puts the JAX package's
``IRHeader`` (flag, label, id, id2) before the payload. This is its pure
Python path; its native reader is not ported. ``pack_img`` and
``unpack_img`` decode images and wait with the other image decoders.

A reader opened before a fork reopens its file in the child at its first
seek or read, so the DataLoader's fork workers do not move one shared
file offset.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as _np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IndexedRecordIO", "IRHeader",
           "pack", "unpack"]

_MAGIC = 0xCED7230A
_LFLAG_BITS = 29
_LEN_MASK = (1 << _LFLAG_BITS) - 1


class MXRecordIO:
    """Sequential reader (``flag='r'``) or writer (``flag='w'``)."""

    def __init__(self, uri, flag="r"):
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self.open()

    def open(self):
        if self.flag not in ("r", "w"):
            raise ValueError("flag must be 'r' or 'w'")
        self._fh = open(self.uri, "wb" if self.flag == "w" else "rb")
        self._pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            self._fh.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def reset(self):
        self.close()
        self.open()

    def _reader(self):
        if self._pid != os.getpid():
            pos = self._fh.tell()
            self._fh = open(self.uri, "rb")
            self._fh.seek(pos)
            self._pid = os.getpid()
        return self._fh

    def tell(self):
        return self._fh.tell()

    def seek(self, pos):
        assert self.flag == "r", "seek is reader-only"
        self._reader().seek(pos)

    def write(self, buf):
        assert self.flag == "w"
        if isinstance(buf, str):
            buf = buf.encode()
        n = len(buf)
        self._fh.write(struct.pack("<II", _MAGIC, n & _LEN_MASK))
        self._fh.write(buf)
        pad = (4 - n % 4) % 4
        if pad:
            self._fh.write(b"\x00" * pad)

    def read(self):
        """The next record's payload, None at the end of the file."""
        assert self.flag == "r"
        fh = self._reader()
        head = fh.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise IOError(f"invalid record magic {magic:#x} in {self.uri}")
        n = lrec & _LEN_MASK
        data = fh.read(n)
        pad = (4 - n % 4) % 4
        if pad:
            fh.read(pad)
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Random access through a ``.idx`` sidecar of ``key\\tposition``
    lines. ``MXIndexedRecordIO(path)`` derives the sidecar's name from
    the record file's."""

    def __init__(self, idx_path, uri=None, flag="r", key_type=int):
        if uri is None:
            uri = idx_path
            idx_path = os.path.splitext(uri)[0] + ".idx"
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    key, pos = line.strip().split("\t")
                    key = key_type(key)
                    self.idx[key] = int(pos)
                    self.keys.append(key)

    def close(self):
        if self.flag == "w" and getattr(self, "is_open", False):
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def __len__(self):
        return len(self.keys)

    def write_idx(self, idx, buf):
        pos = self.tell()
        self.write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)

    def read_idx(self, idx):
        if idx not in self.idx:
            idx = self.keys[idx]
        self.seek(self.idx[idx])
        return self.read()


IndexedRecordIO = MXIndexedRecordIO

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """``IRHeader`` + payload; a label that is not a number is stored as
    ``flag`` float32 values after the header."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
    else:
        label = _np.asarray(header.label, dtype=_np.float32)
        hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
        hdr += label.tobytes()
    if isinstance(s, str):
        s = s.encode()
    return hdr + s


def unpack(s):
    """``(IRHeader, payload)`` of a packed record."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = _np.frombuffer(s[: flag * 4], _np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s
