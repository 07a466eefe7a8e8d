"""ctypes bindings for the port's C++ host helpers (``csrc/host/pathway_native.cc``).

The library holds the engine's host hot paths: update consolidation
(``pn_consolidate``), batched keyed blake2b row hashing
(``pn_blake2b8_batch``) and the batched WordPiece tokenizer
(``pn_tok_encode_batch``). It is built with ``g++`` at first use (never at
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
import struct
import subprocess
import threading

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
