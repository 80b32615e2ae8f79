"""Checkpoint record log: framed, CRC32C-checked, append-only files of
per-world checkpoint records.

Port of ``marl_hideandseek_tpu/utils/ckptlog.py``, byte for byte in its
file format, so a log written on the TPU replays here and the other way
round:

* a 32-byte header ``<IIIIQQ``: magic ``0x4B434C48``, version 1, worlds,
  bytes a world, reserved, frames (written on close; 0 while a writer is
  open, and readers index the frames by scanning, so such a log reads);
* each frame: a ``<QII`` header (index, CRC32C of the payload, flags 0),
  then the payload, ``worlds x bytes`` u8 in world order.

``CkptLogWriter`` and ``CkptLogReader`` run on the native codec,
``csrc/ckptlog.cpp``, built with the host C++ compiler at first use
(``ops/build.py::load_host``); a failed build raises with the compiler's
output. ``write_log_plain`` / ``read_log_plain`` and ``crc32c_plain`` are
the same format in pure Python: the plain version the tests hold the
native codec to, never a fallback.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Iterable, Tuple

import numpy as np

MAGIC = 0x4B434C48
VERSION = 1
HEADER = struct.Struct("<IIIIQQ")      # magic, version, worlds, bytes, res, n
FRAME = struct.Struct("<QII")          # index, crc, flags

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from marl_hideandseek_torch.ops import build

        lib = build.load_host("ckptlog")
        u32, u64, vp, cp = (ctypes.c_uint32, ctypes.c_uint64,
                            ctypes.c_void_p, ctypes.c_char_p)
        for name, res, args in (
                ("ckptlog_create", vp, [cp, u32, u32]),
                ("ckptlog_append", ctypes.c_int, [vp, cp]),
                ("ckptlog_close_writer", ctypes.c_int, [vp]),
                ("ckptlog_open", vp, [cp]),
                ("ckptlog_num_frames", u64, [vp]),
                ("ckptlog_num_worlds", u32, [vp]),
                ("ckptlog_frame_bytes", u32, [vp]),
                ("ckptlog_read", ctypes.c_int, [vp, u64, cp]),
                ("ckptlog_close_reader", ctypes.c_int, [vp]),
                ("ckptlog_crc32c", u32, [cp, u64])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _LIB = lib
    return _LIB


def _frame_bytes(frame, num_worlds: int, frame_bytes: int) -> bytes:
    """A ``[W, bytes]`` u8 tensor or array as the payload's bytes."""
    if hasattr(frame, "detach"):
        frame = frame.detach().cpu().numpy()
    arr = np.ascontiguousarray(frame)
    if arr.dtype != np.uint8 or arr.shape != (num_worlds, frame_bytes):
        raise ValueError(f"a frame must be [{num_worlds}, {frame_bytes}] "
                         f"uint8, got {arr.shape} {arr.dtype}")
    return arr.tobytes()


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of ``data``, by the native codec."""
    return int(_lib().ckptlog_crc32c(data, len(data)))


class CkptLogWriter:
    """Append-only writer: ``append([W, bytes] u8)`` per frame, then
    ``close()`` (or use it as a context manager)."""

    def __init__(self, path: str, num_worlds: int, frame_bytes: int):
        self.path = str(path)
        self.num_worlds = int(num_worlds)
        self.frame_bytes = int(frame_bytes)
        self._h = _lib().ckptlog_create(self.path.encode(), self.num_worlds,
                                        self.frame_bytes)
        if not self._h:
            raise OSError(f"ckptlog: cannot create {self.path}")

    def append(self, frame) -> None:
        """Append one frame: a ``[num_worlds, frame_bytes]`` uint8 tensor
        or numpy array."""
        if not self._h:
            raise ValueError(f"ckptlog: {self.path} is closed")
        rc = _lib().ckptlog_append(
            self._h, _frame_bytes(frame, self.num_worlds, self.frame_bytes))
        if rc != 0:
            raise OSError(f"ckptlog: append to {self.path} failed ({rc})")

    def close(self) -> None:
        if self._h:
            _lib().ckptlog_close_writer(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CkptLogReader:
    """Random-access reader: ``num_frames``, ``num_worlds``,
    ``frame_bytes`` and ``read(i)`` -> ``[W, bytes]`` u8, each frame's
    CRC32C checked (a mismatch raises)."""

    def __init__(self, path: str):
        self.path = str(path)
        lib = _lib()
        self._h = lib.ckptlog_open(self.path.encode())
        if not self._h:
            raise OSError(f"ckptlog: cannot open {self.path} (missing, or "
                          f"not a version-{VERSION} record log)")
        self.num_frames = int(lib.ckptlog_num_frames(self._h))
        self.num_worlds = int(lib.ckptlog_num_worlds(self._h))
        self.frame_bytes = int(lib.ckptlog_frame_bytes(self._h))

    def read(self, idx: int) -> np.ndarray:
        """Frame ``idx`` as ``[num_worlds, frame_bytes]`` uint8."""
        if not 0 <= idx < self.num_frames:
            raise IndexError(f"ckptlog: frame {idx} of {self.num_frames}")
        out = ctypes.create_string_buffer(self.num_worlds * self.frame_bytes)
        rc = _lib().ckptlog_read(self._h, idx, out)
        if rc == -2:
            raise OSError(f"ckptlog: CRC mismatch at frame {idx} of "
                          f"{self.path}")
        if rc != 0:
            raise OSError(f"ckptlog: reading frame {idx} of {self.path} "
                          f"failed ({rc})")
        return np.frombuffer(out.raw, np.uint8).reshape(
            self.num_worlds, self.frame_bytes)

    def close(self) -> None:
        if self._h:
            _lib().ckptlog_close_reader(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- the plain version ----------------------------------------------------------

def _crc_table():
    t = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
        t.append(c)
    return t


_TABLE = _crc_table()


def crc32c_plain(data: bytes) -> int:
    """CRC32C (Castagnoli), table-driven in Python."""
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def write_log_plain(path: str, num_worlds: int, frame_bytes: int,
                    frames: Iterable, num_frames_in_header: bool = True
                    ) -> None:
    """The file ``CkptLogWriter`` writes for ``frames``; with
    ``num_frames_in_header`` False the header's count stays 0, as in a log
    whose writer never closed."""
    n = 0
    with open(path, "wb") as f:
        f.write(HEADER.pack(MAGIC, VERSION, num_worlds, frame_bytes, 0, 0))
        for frame in frames:
            buf = _frame_bytes(frame, num_worlds, frame_bytes)
            f.write(FRAME.pack(n, crc32c_plain(buf), 0))
            f.write(buf)
            n += 1
        if num_frames_in_header:
            f.seek(0)
            f.write(HEADER.pack(MAGIC, VERSION, num_worlds, frame_bytes, 0,
                                n))


def read_log_plain(path: str) -> Tuple[int, int, np.ndarray]:
    """(num_worlds, frame_bytes, frames ``[F, W, bytes]`` u8) of a log,
    every frame found by scanning and its CRC32C checked."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, w, nb, _, _ = HEADER.unpack_from(data, 0)
    if magic != MAGIC or version != VERSION:
        raise OSError(f"ckptlog: {path} is not a version-{VERSION} log")
    payload = w * nb
    frames, off = [], HEADER.size
    while off + FRAME.size + payload <= len(data):
        _, crc, _ = FRAME.unpack_from(data, off)
        buf = data[off + FRAME.size:off + FRAME.size + payload]
        if crc32c_plain(buf) != crc:
            raise OSError(f"ckptlog: CRC mismatch at frame {len(frames)} of "
                          f"{path}")
        frames.append(np.frombuffer(buf, np.uint8).reshape(w, nb))
        off += FRAME.size + payload
    return w, nb, np.stack(frames) if frames else np.zeros((0, w, nb),
                                                            np.uint8)
