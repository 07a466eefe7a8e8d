"""ctypes bindings for the port's C++ host helpers (``csrc/host/pathway_native.cc``).

The library holds the engine's host hot paths: update consolidation
(``pn_consolidate``), batched keyed blake2b row hashing
(``pn_blake2b8_batch``), the batched WordPiece tokenizer
(``pn_tok_encode_batch``, and ``pn_tok_encode_shard`` for the ingest
stage's workers) and the CRC-checked snapshot log of the persistence
plane (``pn_log_*``: :class:`SnapshotLogWriter`, :class:`SnapshotLogReader`). It is built with ``g++`` at first use (never at
import) into ``build/pathway_tpu_torch/`` at the repository root, keyed by
the hash of the source and the flags, and bound with ``ctypes``.

There is no silent fallback: a failed build raises. ``PATHWAY_DISABLE_NATIVE=1``
asks for the Python paths instead; then :func:`library` returns None and
each caller takes its Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import struct
import subprocess
import threading
from typing import Any, Iterator

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "csrc", "host", "pathway_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "pathway_tpu_torch")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)

_SIGS = {
    "pn_consolidate": ([_u8p, ctypes.c_uint64], ctypes.c_void_p),
    "pn_buf_read": ([ctypes.c_void_p, ctypes.POINTER(_u8p), _u64p], None),
    "pn_buf_free": ([ctypes.c_void_p], None),
    "pn_blake2b8_batch": ([_u8p, _u64p, ctypes.c_uint64, _u8p, ctypes.c_uint32, _u64p], None),
    "pn_tok_new": ([ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32], ctypes.c_void_p),
    "pn_tok_free": ([ctypes.c_void_p], None),
    "pn_tok_info": ([ctypes.c_void_p] + [_i32p] * 5, None),
    "pn_tok_encode_batch": ([ctypes.c_void_p, _u8p, _u64p, ctypes.c_uint64, ctypes.c_int32, _i32p, _i32p], None),
    "pn_tok_encode_shard": (
        [ctypes.c_void_p, _u8p, _u64p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32, _i32p, _i32p], None
    ),
    "pn_log_open_write": ([ctypes.c_char_p, ctypes.c_int32], ctypes.c_void_p),
    "pn_log_append": ([ctypes.c_void_p, ctypes.c_uint8, ctypes.c_uint64, ctypes.c_uint64, _u8p, ctypes.c_uint64],
                      ctypes.c_int32),
    "pn_log_flush": ([ctypes.c_void_p], ctypes.c_int32),
    "pn_log_close_write": ([ctypes.c_void_p], None),
    "pn_log_open_read": ([ctypes.c_char_p], ctypes.c_void_p),
    "pn_log_next": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), _u64p, _u64p, ctypes.POINTER(_u8p), _u64p],
                    ctypes.c_int32),
    "pn_log_close_read": ([ctypes.c_void_p], None),
    "pn_store_new": ([], ctypes.c_void_p),
    "pn_store_free": ([ctypes.c_void_p], None),
    "pn_store_len": ([ctypes.c_void_p], ctypes.c_uint64),
    "pn_store_upsert": ([ctypes.c_void_p, ctypes.c_uint64, _u8p, ctypes.c_uint64], ctypes.c_int32),
    "pn_store_remove": ([ctypes.c_void_p, ctypes.c_uint64], ctypes.c_int32),
    "pn_store_get": ([ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(_u8p), _u64p], ctypes.c_int32),
    "pn_store_contains": ([ctypes.c_void_p, ctypes.c_uint64], ctypes.c_int32),
    "pn_store_clear": ([ctypes.c_void_p], None),
    "pn_store_scratch": ([ctypes.c_void_p, ctypes.POINTER(_u8p), _u64p], None),
    "pn_store_iter_new": ([ctypes.c_void_p], ctypes.c_void_p),
    "pn_store_iter_next": ([ctypes.c_void_p, _u64p, ctypes.POINTER(_u8p), _u64p], ctypes.c_int32),
    "pn_store_iter_free": ([ctypes.c_void_p], None),
    "pn_store_snapshot": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint8, ctypes.c_uint64], ctypes.c_int64),
    "pn_store_load": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint8], ctypes.c_int64),
    "pn_version": ([], ctypes.c_char_p),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def disabled() -> bool:
    """``PATHWAY_DISABLE_NATIVE`` set: the caller asked for the Python paths."""
    return bool(os.environ.get("PATHWAY_DISABLE_NATIVE"))


def lib_path() -> str:
    """The library's path, keyed by the source and the flags."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpathway_native-{h.hexdigest()[:16]}.so")


def _build() -> str:
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # pid-unique temp + atomic replace: concurrent processes (pytest-xdist
    # workers on a fresh checkout) each build a copy and the last one wins
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC} (rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL | None:
    """The bound library, built on first use; None when disabled."""
    global _LIB
    if disabled():
        return None
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            for name, (argtypes, restype) in _SIGS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
        return _LIB


def is_available() -> bool:
    """True unless the Python paths were asked for; builds the library."""
    return library() is not None


def _as_u8p(b: bytes):
    return ctypes.cast(ctypes.c_char_p(b), _u8p)


def consolidate_native(updates: list) -> list | None:
    """Native consolidation. ``updates`` is a list of (key, row, diff);
    returns the consolidated list, or None when native is disabled or a
    row is not exactly byte-serializable (arbitrary objects: the caller
    then takes the Python path, whose ``rows_equal`` honours a
    user-defined ``__eq__``). On exact rows, byte equality of the
    canonical serialization coincides with ``values_equal``, so the
    grouping matches."""
    lib = library()
    if lib is None:
        return None
    from .engine.value import _serialize_for_hash

    packed = bytearray()
    for idx, (key, row, diff) in enumerate(updates):
        canon = bytearray()
        if not _serialize_for_hash(row, canon):
            return None
        packed += struct.pack("<QqII", int(key) & 0xFFFFFFFFFFFFFFFF, diff, idx, len(canon))
        packed += canon
    buf = lib.pn_consolidate(_as_u8p(bytes(packed)), len(packed))
    ptr = _u8p()
    length = ctypes.c_uint64()
    lib.pn_buf_read(buf, ctypes.byref(ptr), ctypes.byref(length))
    raw = ctypes.string_at(ptr, length.value)
    lib.pn_buf_free(buf)
    (n,) = struct.unpack_from("<I", raw, 0)
    out = []
    off = 4
    for _ in range(n):
        idx, diff = struct.unpack_from("<Iq", raw, off)
        off += 12
        key, row, _ = updates[idx]
        out.append((key, row, diff))
    return out


def blake2b8_batch(buf: bytes, offsets, key: bytes):
    """Keyed blake2b-8 digests over n messages packed in ``buf`` at
    ``offsets`` (uint64 ndarray, n+1 entries) -> uint64 ndarray, or None
    when native is disabled (the caller then uses hashlib)."""
    lib = library()
    if lib is None:
        return None
    import numpy as np

    offs = np.ascontiguousarray(offsets, np.uint64)
    n = len(offs) - 1
    out = np.empty(n, np.uint64)
    lib.pn_blake2b8_batch(
        _as_u8p(buf), offs.ctypes.data_as(_u64p), n, _as_u8p(key), len(key), out.ctypes.data_as(_u64p)
    )
    return out


class NativeTokenizer:
    """Batched WordPiece tokenizer backed by ``pn_tok_encode_batch``: the
    embedder's host hot path, with the same ids as the Python ``encode``
    on ASCII text."""

    __slots__ = ("_h", "_lib", "cls_id", "sep_id", "pad_id", "unk_id", "has_vocab")

    def __init__(self, vocab_file: str | None, vocab_size: int, lowercase: bool, max_chars: int = 100):
        lib = library()
        if lib is None:
            raise RuntimeError("NativeTokenizer: PATHWAY_DISABLE_NATIVE is set")
        self._lib = lib
        self._h = lib.pn_tok_new((vocab_file or "").encode(), vocab_size, 1 if lowercase else 0, max_chars)
        vals = [ctypes.c_int32() for _ in range(5)]
        lib.pn_tok_info(self._h, *[ctypes.byref(v) for v in vals])
        self.cls_id, self.sep_id, self.pad_id, self.unk_id = (v.value for v in vals[:4])
        self.has_vocab = bool(vals[4].value)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pn_tok_free(self._h)
            self._h = None

    def encode_batch(self, texts: list[str], max_len: int):
        """-> (ids [n, max_len] int32 ndarray, lens [n] int32 ndarray)"""
        import numpy as np

        blobs = [t.encode("utf-8") for t in texts]
        n = len(blobs)
        offsets = np.zeros(n + 1, np.uint64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        out_ids = np.empty((n, max_len), np.int32)
        out_lens = np.empty(n, np.int32)
        self._lib.pn_tok_encode_batch(
            self._h, _as_u8p(b"".join(blobs)), offsets.ctypes.data_as(_u64p), n, max_len,
            out_ids.ctypes.data_as(_i32p), out_lens.ctypes.data_as(_i32p),
        )
        return out_ids, out_lens

    @staticmethod
    def prepare_blob(texts: list[str]):
        """-> (concatenated utf-8 bytes, [n+1] uint64 offsets) for
        :meth:`encode_shard`."""
        import numpy as np

        blobs = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(blobs) + 1, np.uint64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        return b"".join(blobs), offsets

    def encode_shard(self, blob, offsets, row_begin: int, row_end: int, max_len: int, out_ids, out_lens) -> None:
        """Encode rows ``[row_begin, row_end)`` of a prepared blob into the
        shared ``(n, max_len)`` matrices. ctypes drops the GIL for the
        call, so ingest workers encoding disjoint shards run in parallel."""
        self._lib.pn_tok_encode_shard(
            self._h, _as_u8p(blob), offsets.ctypes.data_as(_u64p), row_begin, row_end, max_len,
            out_ids.ctypes.data_as(_i32p), out_lens.ctypes.data_as(_i32p),
        )


_MASK64 = 0xFFFFFFFFFFFFFFFF
_MISSING = object()


class NativeStore:
    """A dict-like ``uint64 -> object`` store on the C++ blob store
    (``pn_store_*``); values are pickled. It snapshots to a
    :class:`SnapshotLogWriter` without a Python loop over its rows
    (``pn_store_snapshot``)."""

    __slots__ = ("_h", "_lib")

    def __init__(self):
        lib = library()
        if lib is None:
            raise RuntimeError("NativeStore: PATHWAY_DISABLE_NATIVE is set")
        self._lib = lib
        self._h = lib.pn_store_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pn_store_free(self._h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.pn_store_len(self._h)

    def __contains__(self, key: int) -> bool:
        return bool(self._lib.pn_store_contains(self._h, ctypes.c_uint64(int(key) & _MASK64)))

    def __setitem__(self, key: int, value: Any) -> None:
        blob = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        self._lib.pn_store_upsert(self._h, ctypes.c_uint64(int(key) & _MASK64), _as_u8p(blob), len(blob))

    def __getitem__(self, key: int) -> Any:
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def get(self, key: int, default: Any = None) -> Any:
        ptr = _u8p()
        length = ctypes.c_uint64()
        if not self._lib.pn_store_get(self._h, ctypes.c_uint64(int(key) & _MASK64), ctypes.byref(ptr),
                                      ctypes.byref(length)):
            return default
        return pickle.loads(ctypes.string_at(ptr, length.value))

    def pop(self, key: int, default: Any = None) -> Any:
        if not self._lib.pn_store_remove(self._h, ctypes.c_uint64(int(key) & _MASK64)):
            return default
        ptr = _u8p()
        length = ctypes.c_uint64()
        self._lib.pn_store_scratch(self._h, ctypes.byref(ptr), ctypes.byref(length))
        return pickle.loads(ctypes.string_at(ptr, length.value))

    def clear(self) -> None:
        self._lib.pn_store_clear(self._h)

    def items(self) -> Iterator[tuple[int, Any]]:
        it = self._lib.pn_store_iter_new(self._h)
        try:
            key = ctypes.c_uint64()
            ptr = _u8p()
            length = ctypes.c_uint64()
            while self._lib.pn_store_iter_next(it, ctypes.byref(key), ctypes.byref(ptr), ctypes.byref(length)):
                yield key.value, pickle.loads(ctypes.string_at(ptr, length.value))
        finally:
            self._lib.pn_store_iter_free(it)

    def keys(self) -> Iterator[int]:
        for k, _ in self.items():
            yield k

    def __iter__(self) -> Iterator[int]:
        return self.keys()

    def snapshot_to(self, log: "SnapshotLogWriter", kind: int, time: int) -> int:
        """Append every entry to ``log`` as ``(kind, time, key, blob)``
        records; returns how many."""
        n = self._lib.pn_store_snapshot(self._h, log._h, kind, ctypes.c_uint64(time))
        if n < 0:
            raise OSError("native snapshot write failed")
        return n

    def load_from(self, log: "SnapshotLogReader", kind: int) -> int:
        """Load the ``kind`` records of ``log``; returns how many."""
        return self._lib.pn_store_load(self._h, log._h, kind)


class SnapshotLogWriter:
    """CRC-checked append-only log (``pn_log_*``). A record is
    ``(kind, time, key, blob)``; the file format is the reference
    package's, byte for byte."""

    def __init__(self, path: str, append: bool = True):
        lib = library()
        if lib is None:
            raise RuntimeError("SnapshotLogWriter: PATHWAY_DISABLE_NATIVE is set")
        self._lib = lib
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self._h = lib.pn_log_open_write(path.encode(), 1 if append else 0)
        if not self._h:
            raise OSError(f"cannot open snapshot log for write: {path}")

    def append(self, kind: int, time: int, key: int, blob: bytes) -> None:
        ok = self._lib.pn_log_append(
            self._h, kind, ctypes.c_uint64(time), ctypes.c_uint64(int(key) & 0xFFFFFFFFFFFFFFFF), _as_u8p(blob),
            len(blob),
        )
        if not ok:
            raise OSError("snapshot log append failed")

    def append_obj(self, kind: int, time: int, key: int, obj: Any) -> None:
        self.append(kind, time, key, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

    def flush(self) -> None:
        self._lib.pn_log_flush(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.pn_log_close_write(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SnapshotLogReader:
    """Reads a :class:`SnapshotLogWriter` log's records until the end of
    the file or the first torn or corrupt record."""

    def __init__(self, path: str):
        lib = library()
        if lib is None:
            raise RuntimeError("SnapshotLogReader: PATHWAY_DISABLE_NATIVE is set")
        self._lib = lib
        self._h = lib.pn_log_open_read(path.encode())
        if not self._h:
            raise FileNotFoundError(path)

    def __iter__(self) -> Iterator[tuple[int, int, int, bytes]]:
        kind = ctypes.c_uint8()
        time = ctypes.c_uint64()
        key = ctypes.c_uint64()
        ptr = _u8p()
        length = ctypes.c_uint64()
        while self._lib.pn_log_next(
            self._h, ctypes.byref(kind), ctypes.byref(time), ctypes.byref(key), ctypes.byref(ptr),
            ctypes.byref(length),
        ):
            yield kind.value, time.value, key.value, ctypes.string_at(ptr, length.value)

    def iter_objects(self) -> Iterator[tuple[int, int, int, Any]]:
        for kind, time, key, blob in self:
            yield kind, time, key, pickle.loads(blob)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.pn_log_close_read(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
