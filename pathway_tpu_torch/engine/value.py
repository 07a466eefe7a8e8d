"""Runtime value system: keys, pointers, Json, datetimes.

A rebuild of the reference's value layer
(upstream Pathway's src/engine/value.rs). Keys are 64-bit hashes (uint64) so
key columns are dense device-friendly arrays; the reference uses 128-bit
keys (value.rs:41) — 64 bits keeps keys in one numpy/XLA lane and the
collision probability at the target scales (~10M rows) is negligible.
"""

from __future__ import annotations

import datetime
import hashlib
import json as _json
import struct
from typing import Any, Iterable

import numpy as np

# Salt mirrors the role of the reference's seeded SipHash keyspace.
_HASH_SALT = b"pathway_tpu-key-v1"

# Low bits of a key pick the shard/worker, like the reference's
# SHARD_MASK (value.rs:38, shard.rs:15-20).
SHARD_BITS = 16
SHARD_MASK = (1 << SHARD_BITS) - 1


class Pointer(int):
    """A row key. Subclass of int so it hashes/compares natively but
    prints like the reference's `^...` pointers."""

    def __repr__(self) -> str:
        return f"^{self:016X}"

    def __str__(self) -> str:
        return self.__repr__()


class Error:
    """Singleton ERROR value (value.rs Error variant). Propagates through
    expressions; filtered from outputs unless explicitly kept."""

    _instance: "Error | None" = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Error"

    def __bool__(self):
        raise ValueError("ERROR value is not convertible to bool")


ERROR = Error()


class Json:
    """JSON value wrapper (mirrors pw.Json). Wraps any json-serializable
    python value."""

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        if isinstance(value, Json):
            value = value.value
        self.value = value

    def __repr__(self) -> str:
        return _json.dumps(self.value, sort_keys=True, default=str)

    def __eq__(self, other):
        if isinstance(other, Json):
            return self.value == other.value
        return self.value == other

    def __hash__(self):
        try:
            return hash(_json.dumps(self.value, sort_keys=True, default=str))
        except TypeError:
            return 0

    def __getitem__(self, item):
        v = self.value[item]
        return Json(v) if isinstance(v, (dict, list)) else v

    def __contains__(self, item):
        return item in self.value

    def __iter__(self):
        if isinstance(self.value, dict):
            return iter(self.value)
        return (Json(v) if isinstance(v, (dict, list)) else v for v in self.value)

    def __len__(self):
        return len(self.value)

    def get(self, key, default=None):
        if isinstance(self.value, dict):
            v = self.value.get(key, default)
            return Json(v) if isinstance(v, (dict, list)) else v
        return default

    def as_int(self) -> int | None:
        return int(self.value) if isinstance(self.value, (int, float)) and not isinstance(self.value, bool) else None

    def as_float(self) -> float | None:
        return float(self.value) if isinstance(self.value, (int, float)) and not isinstance(self.value, bool) else None

    def as_str(self) -> str | None:
        return self.value if isinstance(self.value, str) else None

    def as_bool(self) -> bool | None:
        return self.value if isinstance(self.value, bool) else None

    def as_list(self) -> list | None:
        return self.value if isinstance(self.value, list) else None

    def as_dict(self) -> dict | None:
        return self.value if isinstance(self.value, dict) else None

    @staticmethod
    def parse(s: str | bytes) -> "Json":
        return Json(_json.loads(s))

    @staticmethod
    def dumps(value: Any) -> str:
        if isinstance(value, Json):
            value = value.value
        return _json.dumps(value, default=str)


class PyObjectWrapper:
    """Opaque python object carried through the engine (value.rs
    PyObjectWrapper)."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def __repr__(self):
        return f"PyObjectWrapper({self.value!r})"

    def __eq__(self, other):
        return isinstance(other, PyObjectWrapper) and self.value == other.value

    def __hash__(self):
        try:
            return hash(self.value)
        except TypeError:
            return 0


def wrap_py_object(value: Any) -> PyObjectWrapper:
    return PyObjectWrapper(value)


def _serialize_for_hash(value: Any, out: bytearray) -> bool:
    """Stable byte serialization of a value for key derivation.

    Returns True when the serialization is *exact* — byte equality of two
    serializations coincides with `values_equal` — and False when a lossy
    fallback (repr of an arbitrary object) was used. Consolidation only
    trusts byte-grouping for exact rows (see native.consolidate_native)."""
    if value is None:
        out += b"\x00"
    elif isinstance(value, Pointer):
        out += b"\x07" + struct.pack("<Q", int(value) & 0xFFFFFFFFFFFFFFFF)
    elif isinstance(value, bool) or isinstance(value, np.bool_):
        out += b"\x01" + (b"\x01" if value else b"\x00")
    elif isinstance(value, (int, np.integer)):
        iv = int(value)
        if -(2**62) <= iv < 2**62:
            out += b"\x02" + struct.pack("<q", iv)
        elif -(2**63) <= iv < 2**63:
            # [2^62, 2^63): fits i64, but an integral FLOAT of equal
            # numeric value serializes under the float tag — byte
            # equality stops tracking the numeric tower here, so report
            # INEXACT (consolidation then groups via values_equal)
            out += b"\x02" + struct.pack("<q", iv)
            return False
        else:
            # Python ints are unbounded (a uint64-backed id column read
            # back as a row value already exceeds i64); wide ints get a
            # length-prefixed two's-complement encoding under their OWN
            # tag — reusing \x02 would make the stream ambiguous with a
            # small int whose first packed byte collides. Inexact for
            # the same numeric-tower reason as the band above.
            b = iv.to_bytes((iv.bit_length() + 8) // 8, "little", signed=True)
            out += b"\x0d" + struct.pack("<I", len(b)) + b
            return False
    elif isinstance(value, (float, np.floating)):
        f = float(value)
        if f != f:
            # canonical NaN: all payload bit-patterns serialize identically
            out += b"\x03" + struct.pack("<d", float("nan"))
        elif f.is_integer() and abs(f) < 2**62:
            # int/float hash consistency like python's numeric tower
            out += b"\x02" + struct.pack("<q", int(f))
        elif f.is_integer():
            # integral float >= 2^62: an INT of equal value serializes
            # differently — inexact, the other side of the band above
            out += b"\x03" + struct.pack("<d", f)
            return False
        else:
            out += b"\x03" + struct.pack("<d", f)
    elif isinstance(value, str):
        b = value.encode()
        out += b"\x04" + struct.pack("<I", len(b)) + b
    elif isinstance(value, bytes):
        out += b"\x05" + struct.pack("<I", len(value)) + value
    elif isinstance(value, (tuple, list)):
        # distinct tags: tuple vs list are != in python
        out += (b"\x06" if isinstance(value, tuple) else b"\x0c") + struct.pack("<I", len(value))
        exact = True
        for v in value:
            exact = _serialize_for_hash(v, out) and exact
        return exact
    elif isinstance(value, np.ndarray):
        if value.dtype == object:
            # object arrays: element-wise recursion (tobytes would hash
            # pointers — non-deterministic)
            out += b"\x08o" + struct.pack("<I", value.ndim)
            for dim in value.shape:
                out += struct.pack("<q", dim)
            exact = True
            for v in value.ravel().tolist():
                exact = _serialize_for_hash(v, out) and exact
            return exact
        out += b"\x08" + value.tobytes() + str(value.dtype).encode()
        out += struct.pack("<I", value.ndim)
        for dim in value.shape:
            out += struct.pack("<q", dim)
    elif isinstance(value, (datetime.datetime, datetime.timedelta)):
        # repr-based: byte equality implies ==, but not vice versa
        # (equal instants under different tzinfo) → inexact
        out += b"\x09" + repr(value).encode()
        return False
    elif isinstance(value, Json):
        # repr-based: {'a': 1} vs {'a': 1.0} are == but repr-distinct
        out += b"\x0a" + repr(value).encode()
        return False
    else:
        out += b"\x0b" + repr(value).encode()
        return False
    return True


def ref_scalar(*values: Any, optional: bool = False) -> Pointer:
    """Derive a deterministic key from values (reference python_api.rs:3369
    `ref_scalar`). Used for primary keys (`with_id_from`) and re-keying."""
    if optional and any(v is None for v in values):
        return None  # type: ignore
    out = bytearray()
    _serialize_for_hash(tuple(values), out)
    digest = hashlib.blake2b(bytes(out), digest_size=8, key=_HASH_SALT).digest()
    return Pointer(struct.unpack("<Q", digest)[0])


def unsafe_make_pointer(value: int) -> Pointer:
    return Pointer(value & 0xFFFFFFFFFFFFFFFF)


def ref_scalar_columns(cols: list[np.ndarray]) -> np.ndarray | None:
    """Vectorized ``ref_scalar`` over parallel typed columns: key i is
    ``ref_scalar(cols[0][i], …, cols[k-1][i])``, byte-identical to the
    per-row path (same serialization, same keyed blake2b-8).

    The per-tuple messages are built as one numpy structured array (no
    per-row Python), then hashed natively in one call
    (pn_blake2b8_batch); hashlib loops over the packed buffer when the
    native lib is absent. Returns None for unsupported dtypes (strings,
    objects) — caller falls back to per-row ref_scalar.
    """
    if not cols:
        return None
    n = len(cols[0])
    fields: list[tuple[str, str]] = [("hdr", "u1"), ("cnt", "<u4")]
    fillers = []
    for j, c in enumerate(cols):
        kind = c.dtype.kind
        tag_f, val_f = f"t{j}", f"v{j}"
        if kind == "b":
            fields += [(tag_f, "u1"), (val_f, "u1")]

            def fill_bool(rec, c=c, tf=tag_f, vf=val_f):
                rec[tf] = 0x01
                rec[vf] = c.view(np.uint8)

            fillers.append(fill_bool)
        elif kind in "iu":
            if kind == "u" and c.dtype.itemsize == 8 and (c >> np.uint64(63)).any():
                return None  # doesn't fit <q
            fields += [(tag_f, "u1"), (val_f, "<q")]

            def fill_int(rec, c=c, tf=tag_f, vf=val_f):
                rec[tf] = 0x02
                rec[vf] = c.astype(np.int64, copy=False)

            fillers.append(fill_int)
        elif kind == "f":
            fields += [(tag_f, "u1"), (val_f, "<u8")]

            def fill_float(rec, c=c, tf=tag_f, vf=val_f):
                v = c.astype(np.float64, copy=False)
                nan = np.isnan(v)
                # int/float hash consistency: integral floats < 2^62
                # serialize with the int tag (see _serialize_for_hash)
                with np.errstate(invalid="ignore"):
                    as_int = (v == np.floor(v)) & (np.abs(v) < 2**62) & ~nan
                bits = v.view(np.uint64).copy()
                # canonical NaN bit pattern (struct.pack('<d', nan))
                bits[nan] = np.uint64(0x7FF8000000000000)
                ints = np.where(as_int, v, 0.0).astype(np.int64).view(np.uint64)
                rec[tf] = np.where(as_int, np.uint8(0x02), np.uint8(0x03))
                rec[vf] = np.where(as_int, ints, bits)

            fillers.append(fill_float)
        else:
            return None
    rec = np.zeros(n, dtype=np.dtype(fields, align=False))
    rec["hdr"] = 0x06  # tuple tag
    rec["cnt"] = len(cols)
    for f in fillers:
        f(rec)
    buf = rec.tobytes()
    itemsize = rec.dtype.itemsize
    offsets = np.arange(n + 1, dtype=np.uint64) * np.uint64(itemsize)
    from .. import native as _nat

    out = _nat.blake2b8_batch(buf, offsets, _HASH_SALT)
    if out is None:
        out = np.fromiter(
            (
                struct.unpack(
                    "<Q",
                    hashlib.blake2b(
                        buf[i * itemsize : (i + 1) * itemsize],
                        digest_size=8,
                        key=_HASH_SALT,
                    ).digest(),
                )[0]
                for i in range(n)
            ),
            np.uint64,
            n,
        )
    return out


_SEQ_COUNTER = [0]


def sequential_key() -> Pointer:
    """Auto-generated key for rows without a primary key. Hash of a
    sequence number so keys are stable within a run and well-spread
    across shards."""
    _SEQ_COUNTER[0] += 1
    return ref_scalar("__seq__", _SEQ_COUNTER[0])


def shard_of(key: int, n_shards: int) -> int:
    """Worker owning a key: low bits mod n_shards (shard.rs:15-20)."""
    return (int(key) & SHARD_MASK) % n_shards


def shard_of_array(keys: np.ndarray, n_shards: int) -> np.ndarray:
    return (keys & np.uint64(SHARD_MASK)) % np.uint64(n_shards)


def hash_int_array(values: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64-style hash of an int64/uint64 array → uint64
    keys. Device-friendly (pure integer ops, usable inside jit too)."""
    x = values.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def values_equal(a: Any, b: Any) -> bool:
    """Row-value equality. Defined to coincide with byte equality of
    `_serialize_for_hash` on exact values, so the python and native
    consolidation paths group rows identically: bool is distinct from
    int, NaN == NaN (so stored NaN rows are retractable), arrays compare
    bitwise with dtype+shape."""
    if a is b:
        return True
    if isinstance(a, (bool, np.bool_)) != isinstance(b, (bool, np.bool_)):
        return False
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)):
            return False
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype == object:
            return all(values_equal(x, y) for x, y in zip(a.ravel().tolist(), b.ravel().tolist()))
        return a.tobytes() == b.tobytes()
    if isinstance(a, (float, np.floating)) and a != a:
        return isinstance(b, (float, np.floating)) and b != b
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        # recurse so nested bool/NaN/array semantics match the serializer
        return type(a) is type(b) and len(a) == len(b) and all(
            values_equal(x, y) for x, y in zip(a, b)
        )
    return a == b


def rows_equal(a: tuple, b: tuple) -> bool:
    if len(a) != len(b):
        return False
    return all(values_equal(x, y) for x, y in zip(a, b))
