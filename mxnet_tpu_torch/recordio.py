"""RecordIO: packed binary record files and image record pack/unpack.

Counterpart of ``mxnet_tpu/recordio.py`` (host code, kept as a copy so the
port imports nothing of the JAX package).  The framing is the reference's
(``src/io/iter_image_recordio.cc``, dmlc-core's RecordIO): each frame is
the magic, a word holding a continuation flag in its top 3 bits and the
payload length in the low 29, then the payload padded to 4 bytes; a
record longer than 2^29 - 1 bytes spans frames flagged 1 (first), 2
(middle) and 3 (last).  Files written by either package read in the
other, byte for byte.

Two engines frame and join records the same way, byte for byte: the
native one, :class:`_NativeRecordFile`, a ctypes shim over the port's
``csrc/recordio.cc``, which ``_build.build_recordio`` compiles with g++
at first use (into the build directory, never into the source tree),
and the pure-Python :class:`_PyRecordFile`.  :class:`MXRecordIO` opens
the native engine whenever its library loaded; a failed build logs a
warning with the compiler's output and the Python engine serves.
:func:`engine` names the engine new files open with, and
``MXRecordIO.engine`` the one an open file uses.
"""
from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img", "engine"]

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1

# the native engine's library: None before the first use, False after a
# failed build or load (the Python engine serves), else the CDLL
_native = None
_native_lock = threading.Lock()


def _log_build_failure(err) -> None:
    logging.getLogger(__name__).warning(
        "native recordio engine unavailable; using the pure-Python "
        "engine:\n%s", str(err)[-2000:])


def _load_native():
    """The native engine's library, built and loaded at the first call;
    None where it does not build or load."""
    global _native
    if _native is None:
        with _native_lock:
            if _native is None:
                from . import _build
                try:
                    lib = ctypes.CDLL(str(_build.build_recordio()["lib"]))
                except (MXNetError, OSError) as err:
                    _log_build_failure(err)
                    _native = False
                else:
                    _bind_native(lib)
                    _native = lib
    return _native or None


def _bind_native(lib) -> None:
    c_void_p, c_char_p, c_long, c_int = (ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_long, ctypes.c_int)
    for fn, restype, argtypes in (
            ("MXTRecordIOWriterCreate", c_void_p, [c_char_p]),
            ("MXTRecordIOWriterWriteRecord", c_int,
             [c_void_p, c_char_p, ctypes.c_size_t]),
            ("MXTRecordIOWriterTell", c_long, [c_void_p]),
            ("MXTRecordIOWriterFree", None, [c_void_p]),
            ("MXTRecordIOReaderCreate", c_void_p, [c_char_p]),
            ("MXTRecordIOReaderReadRecord", c_int,
             [c_void_p, ctypes.POINTER(c_char_p),
              ctypes.POINTER(ctypes.c_size_t)]),
            ("MXTRecordIOReaderSeek", c_int, [c_void_p, c_long]),
            ("MXTRecordIOReaderTell", c_long, [c_void_p]),
            ("MXTRecordIOReaderFree", None, [c_void_p])):
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes


def engine() -> str:
    """``"native"`` when the native engine's library loaded (building it
    at the first call), else ``"python"``: the engine that
    :class:`MXRecordIO` opens files with."""
    return "native" if _load_native() is not None else "python"


class _PyRecordFile:
    """The pure-Python record engine: frames records on write, joins
    frames on read."""

    name = "python"

    def __init__(self, uri, flag):
        self._fp = open(uri, "wb" if flag == "w" else "rb")
        self._writable = flag == "w"

    def write(self, buf):
        off, first = 0, True
        while True:
            chunk = len(buf) - off
            last = chunk <= _LEN_MASK
            if not last:
                chunk = _LEN_MASK
            cflag = (0 if last else 1) if first else (3 if last else 2)
            self._fp.write(struct.pack("<II", _MAGIC,
                                       (cflag << 29) | chunk))
            self._fp.write(buf[off:off + chunk])
            pad = (4 - (chunk & 3)) & 3
            if pad:
                self._fp.write(b"\0" * pad)
            off += chunk
            first = False
            if off >= len(buf):
                return

    def read(self):
        parts = []
        in_multi = False
        while True:
            head = self._fp.read(8)
            if len(head) == 0 and not in_multi:
                return None
            if len(head) != 8:
                raise MXNetError("corrupt record file: truncated frame")
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise MXNetError("corrupt record file: bad magic")
            cflag, length = lrec >> 29, lrec & _LEN_MASK
            data = self._fp.read(length)
            if len(data) != length:
                raise MXNetError("corrupt record file: truncated payload")
            pad = (4 - (length & 3)) & 3
            if pad:
                self._fp.read(pad)
            parts.append(data)
            if cflag == 0 and not in_multi:
                break
            if cflag == 1 and not in_multi:
                in_multi = True
                continue
            if cflag == 2 and in_multi:
                continue
            if cflag == 3 and in_multi:
                break
            raise MXNetError("corrupt record file: bad continuation flag")
        return b"".join(parts)

    def tell(self):
        return self._fp.tell()

    def seek(self, pos):
        self._fp.seek(pos)

    def close(self):
        self._fp.close()


class _NativeRecordFile:
    """The native record engine: a ctypes shim over ``csrc/recordio.cc``
    with :class:`_PyRecordFile`'s interface."""

    name = "native"

    def __init__(self, uri, flag):
        self._lib = _load_native()
        self._writable = flag == "w"
        path = os.fsencode(uri)
        self._h = (self._lib.MXTRecordIOWriterCreate(path) if self._writable
                   else self._lib.MXTRecordIOReaderCreate(path))
        if not self._h:
            raise MXNetError(f"cannot open record file {uri!r}")

    def write(self, buf):
        buf = bytes(buf)
        if self._lib.MXTRecordIOWriterWriteRecord(self._h, buf,
                                                  len(buf)) != 0:
            raise MXNetError("record write failed")

    def read(self):
        out = ctypes.c_char_p()
        size = ctypes.c_size_t()
        rc = self._lib.MXTRecordIOReaderReadRecord(
            self._h, ctypes.byref(out), ctypes.byref(size))
        if rc == 1:
            return None
        if rc != 0:
            raise MXNetError("corrupt record file")
        return ctypes.string_at(out, size.value)

    def tell(self):
        return (self._lib.MXTRecordIOWriterTell(self._h) if self._writable
                else self._lib.MXTRecordIOReaderTell(self._h))

    def seek(self, pos):
        if self._lib.MXTRecordIOReaderSeek(self._h, pos) != 0:
            raise MXNetError("record seek failed")

    def close(self):
        if self._h:
            if self._writable:
                self._lib.MXTRecordIOWriterFree(self._h)
            else:
                self._lib.MXTRecordIOReaderFree(self._h)
            self._h = None


class MXRecordIO:
    """Sequential record reader/writer (reference ``recordio.py:MXRecordIO``).

    Parameters
    ----------
    uri : str
        Path to the ``.rec`` file.
    flag : str
        ``"r"`` to read, ``"w"`` to write.
    strict : bool, optional
        Corrupt-record policy for reading.  The default (``False``, or
        ``MXNET_TPU_RECORDIO_STRICT=1`` to flip it) SKIPS a corrupt or
        truncated record: the reader logs one warning, bumps
        :attr:`corrupt_count` (and the counter
        ``recordio.corrupt_records``), emits a ``recordio-corrupt`` event
        row, resynchronizes on the next valid record header and keeps
        going.  ``strict=True`` raises on corruption instead.
    """

    def __init__(self, uri, flag, strict=None):
        self.uri = uri
        self.flag = flag
        if strict is None:
            strict = os.environ.get("MXNET_TPU_RECORDIO_STRICT",
                                    "0").strip() not in ("0", "", "false")
        self.strict = bool(strict)
        self.corrupt_count = 0
        self._warned_corrupt = False
        self._last_pos = None
        self.is_open = False
        self.open()

    def open(self):
        cls = (_NativeRecordFile if _load_native() is not None
               else _PyRecordFile)
        self._rec = cls(self.uri, self.flag)
        self.writable = self.flag == "w"
        self.is_open = True

    @property
    def engine(self) -> str:
        """The engine this file reads or writes through: ``"native"`` or
        ``"python"``."""
        return self._rec.name

    def close(self):
        if self.is_open:
            self._rec.close()
            self.is_open = False

    def __del__(self):
        self.close()

    def reset(self):
        """Seek back to the first record (truncates when writing)."""
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self._rec.write(buf)

    def read(self):
        assert not self.writable
        self._last_pos = self._rec.tell()
        try:
            return self._rec.read()
        except MXNetError as err:
            if self.strict:
                raise
            return self._read_resync(err)

    def _read_resync(self, err):
        """Skip past a corrupt record: scan forward (4-byte aligned, the
        framing's alignment) for the next header whose full record
        parses, and continue from there.  Continuation frames of a torn
        multi-frame record reject themselves (a leading cflag 2/3 is a
        framing error), so the scan lands on a true record boundary.
        Returns the next good record, or None when the corruption runs to
        EOF."""
        self.corrupt_count += 1
        from . import profiler, telemetry
        profiler.bump("recordio.corrupt_records")
        # the counter says how many; the event row says where
        telemetry.emit("event", {"event": "recordio-corrupt",
                                 "uri": self.uri,
                                 "count": self.corrupt_count})
        if not self._warned_corrupt:
            logging.getLogger(__name__).warning(
                "corrupt record in %s (%s); skipping — further skips are "
                "only counted on .corrupt_count (strict=True to raise)",
                self.uri, err)
            self._warned_corrupt = True
        size = os.path.getsize(self.uri)
        magic = struct.pack("<I", _MAGIC)
        start = (self._last_pos if self._last_pos is not None else 0) + 1
        pos = start + ((-start) % 4)
        py = _PyRecordFile(self.uri, "r")
        window = 1 << 16
        with open(self.uri, "rb") as f:
            while pos + 8 <= size:
                f.seek(pos)
                chunk = f.read(window)
                i = chunk.find(magic)
                while i != -1:
                    cand = pos + i
                    if cand % 4 == 0 and cand + 8 <= size:
                        py.seek(cand)
                        try:
                            rec = py.read()
                        except MXNetError:
                            rec = False  # the candidate did not parse
                        if rec is not False:
                            self._adopt(py)
                            return rec  # a record, or None at clean EOF
                    i = chunk.find(magic, i + 1)
                # overlap so a header straddling the window edge is seen
                pos += window - 7
        # no record parses to the end: leave the reader at EOF, so later
        # reads return None (a failed candidate left it mid-file)
        py.seek(size)
        self._adopt(py)
        return None

    def _adopt(self, py):
        """Go on from where the resynchronizing engine ``py`` stopped, in
        the engine the file was opened with."""
        if isinstance(self._rec, _NativeRecordFile):
            native = _NativeRecordFile(self.uri, "r")
            native.seek(py.tell())
            py.close()
            py = native
        self._rec.close()
        self._rec = py

    def tell(self):
        return self._rec.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Record file with a ``.idx`` sidecar (``key\\toffset`` lines) for
    random access by key."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as f:
                for line in f:
                    key, pos = line.strip().split("\t")
                    key = key_type(key)
                    self.idx[key] = int(pos)
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def reset(self):
        # truncating the record file invalidates all recorded offsets
        if self.writable:
            self.idx.clear()
            self.keys.clear()
        super().reset()

    def seek(self, idx):
        assert not self.writable
        self._rec.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


# ---------------------------------------------------------------------------
# Image record packing (reference recordio.py IRHeader/pack/unpack/pack_img)
# ---------------------------------------------------------------------------

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Prepend an IRHeader to a payload (image bytes).  A vector label is
    stored after the header as float32s, its length in ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, (list, tuple, np.ndarray)):
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """Split a record payload into (IRHeader, image bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


_RAW_MAGIC = b"RAW0"


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 image and pack it.

    ``img_fmt='.raw'`` stores the pixels uncompressed (magic, the HWC
    shape as three little-endian uint16s, the bytes): decoding is then a
    copy, with no codec.  ``.jpg``/``.jpeg``/``.png`` go through cv2.
    """
    if img_fmt == ".raw":
        img = np.ascontiguousarray(img, dtype=np.uint8)
        if img.ndim == 2:
            img = img[:, :, None]
        h, w, c = img.shape
        if max(h, w, c) > 0xFFFF:
            raise MXNetError(
                f"raw records cap dimensions at 65535, got {img.shape}")
        blob = _RAW_MAGIC + struct.pack("<HHH", h, w, c) + img.tobytes()
        return pack(header, blob)
    import cv2
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        raise MXNetError(f"unsupported image format {img_fmt}")
    ok, buf = cv2.imencode(img_fmt, img, encode_params)
    if not ok:
        raise MXNetError("image encode failed")
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """Unpack a record into (IRHeader, HWC uint8 ndarray); raw records
    (see :func:`pack_img`) skip the codec."""
    header, img_bytes = unpack(s)
    if img_bytes[:4] == _RAW_MAGIC:
        h, w, c = struct.unpack("<HHH", img_bytes[4:10])
        img = np.frombuffer(img_bytes, dtype=np.uint8,
                            offset=10).reshape(h, w, c)
        return header, img
    import cv2
    img = cv2.imdecode(np.frombuffer(img_bytes, dtype=np.uint8), iscolor)
    return header, img
