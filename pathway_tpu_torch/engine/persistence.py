"""Engine persistence: input snapshots + recovery.

The port's copy of the reference package's ``engine/persistence.py``, a
rebuild of upstream Pathway's persistence layer (src/persistence/):
input snapshots — a per-source
append-only event log of committed updates plus finalized-time markers
(input_snapshot.rs, SnapshotEvent::AdvanceTime written at commit,
connectors/mod.rs:536-543) — and the metadata/frontier tracking of
state.rs:35. Storage rides the native CRC log (csrc/host/pathway_native.cc
pn_log_*) when available, with a pure-Python struct+crc32 fallback of
identical record semantics, and an in-memory backend matching the
reference's mock (src/persistence/backends/mock.rs).

Recovery contract (matches worker-arch doc :57-60 — restart all workers
from the last persisted snapshot):

- DATA records carry post-resolution diffs ``(key, row, ±1)`` stamped
  with their original engine epoch; they replay at those epochs before
  any reader thread starts.
- An ADVANCE record finalizes every epoch ``<= time`` for its source and
  snapshots the reader's offsets. DATA past the last ADVANCE is dropped
  at recovery (it was never finalized); the reader re-produces it, since
  offsets only move inside ADVANCE records.
- Sinks are exactly-once across restarts: replayed epochs rebuild
  operator state but are suppressed at OutputNodes
  (``EngineGraph.replay_frontier``).

Trust boundary: checkpoint rows, offsets, and operator snapshots are
encoded with ``pickle`` — anyone with write access to the persistence
root can execute arbitrary code in the recovering process. Treat the
persistence directory (or S3 prefix) with the same trust as the program
itself: same file permissions as the deploying user, no shared writable
buckets. (The reference uses non-executable bincode encodings; a
restricted encoder for the closed Value vocabulary is a possible
hardening step, but arbitrary Python objects in rows — PyObjectWrapper
equivalents, UDF state — make pickle the honest default here.)
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Iterator

from .. import native as _native
from ..internals import flight_recorder

KIND_DATA = 1
KIND_ADVANCE = 2
KIND_OPSNAP = 3
# marker: DATA <= time was dropped because an operator snapshot covers
# it; recovery into a CHANGED program must fail loudly, not silently
# compute from a partial log
KIND_COMPACT = 4
# reader offsets captured at FEED time (not yet finalized): recovery may
# promote the frontier to such an epoch when process 0's delivered
# marker proves its output reached the sinks — closing the
# duplicate-delivery window between p0's sink flush and the worker's
# ADVANCE (exactly-once across the whole crash window)
KIND_FEED = 5

_PY_MAGIC = b"PWPYLOG1"


# ---------------------------------------------------------------------------
# Log implementations: native CRC log, python fallback, in-memory (mock).
# All speak records of (kind: u8, time: u64, key: u64, blob: bytes).
# ---------------------------------------------------------------------------


class PyLogWriter:
    """Pure-Python CRC32-checked append-only record log (fallback for
    the native pn_log_* writer; same durability contract: readers stop
    at the first torn/corrupt record)."""

    def __init__(self, path: str, append: bool = True):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        fresh = not (append and os.path.exists(path) and os.path.getsize(path) > 0)
        self._f = open(path, "ab" if append else "wb")
        if fresh:
            self._f.write(_PY_MAGIC)
            self._f.flush()

    def append(self, kind: int, time: int, key: int, blob: bytes) -> None:
        header = struct.pack("<BQQI", kind, time, key & 0xFFFFFFFFFFFFFFFF, len(blob))
        crc = zlib.crc32(header + blob) & 0xFFFFFFFF
        self._f.write(header + blob + struct.pack("<I", crc))

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class PyLogReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        if self._f.read(len(_PY_MAGIC)) != _PY_MAGIC:
            self._f.close()
            raise OSError(f"not a pathway log: {path}")

    def __iter__(self) -> Iterator[tuple[int, int, int, bytes]]:
        hsize = struct.calcsize("<BQQI")
        while True:
            header = self._f.read(hsize)
            if len(header) < hsize:
                return
            kind, time, key, n = struct.unpack("<BQQI", header)
            body = self._f.read(n + 4)
            if len(body) < n + 4:
                return  # torn tail
            blob, (crc,) = body[:n], struct.unpack("<I", body[n:])
            if zlib.crc32(header + blob) & 0xFFFFFFFF != crc:
                return  # corrupt record: stop, like the native reader
            yield kind, time, key, blob

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class NativeFormatPyReader:
    """Pure-Python reader for the NATIVE log format (PNLOG1, see
    csrc/host/pathway_native.cc pn_log_*: records
    ``[u8 kind][u64 time][u64 key][u64 len][blob][u32 crc]`` with a
    zlib-compatible CRC32 over kind..blob). Keeps native-written logs
    recoverable on hosts where the native toolchain is unavailable."""

    _MAGIC = b"PNLOG1\x00\x00"

    def __init__(self, path: str):
        self._f = open(path, "rb")
        if self._f.read(8) != self._MAGIC:
            self._f.close()
            raise OSError(f"not a native pathway log: {path}")

    def __iter__(self) -> Iterator[tuple[int, int, int, bytes]]:
        hsize = struct.calcsize("<BQQQ")
        while True:
            header = self._f.read(hsize)
            if len(header) < hsize:
                return
            kind, time, key, n = struct.unpack("<BQQQ", header)
            if n > (1 << 40):
                return  # implausible length: corrupt header
            body = self._f.read(n + 4)
            if len(body) < n + 4:
                return
            blob, (crc,) = body[:n], struct.unpack("<I", body[n:])
            if zlib.crc32(header + blob) & 0xFFFFFFFF != crc:
                return
            yield kind, time, key, blob

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def sniff_log_reader(path: str):
    """Open whichever on-disk log format the file carries (a restart may
    flip native availability; both formats stay readable from Python)."""
    try:
        with open(path, "rb") as f:
            magic = f.read(8)
    except OSError:
        return None
    if magic == NativeFormatPyReader._MAGIC:
        return NativeFormatPyReader(path)
    if magic == _PY_MAGIC:
        return PyLogReader(path)
    return None


class MemoryLogWriter:
    """Mock backend: records go to a shared in-process store (the
    ``events`` handed to ``pw.persistence.Backend.mock``), so a
    'restarted' pipeline in the same process recovers from it. Records
    are stamped with their source id: sources must not see each other's
    events when the store is shared."""

    def __init__(self, events: list, source_id: str):
        self._events = events
        self._sid = source_id

    def append(self, kind: int, time: int, key: int, blob: bytes) -> None:
        self._events.append((self._sid, kind, time, key, blob))

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemoryLogReader:
    def __init__(self, events: list, source_id: str):
        self._events = events
        self._sid = source_id

    def __iter__(self):
        for rec in list(self._events):
            if len(rec) == 5:  # (sid, kind, time, key, blob)
                if rec[0] == self._sid:
                    yield rec[1:]
            else:  # legacy unstamped record: assume single-source store
                yield rec

    def close(self) -> None:
        pass


def _use_native() -> bool:
    return _native.is_available() and not os.environ.get("PATHWAY_PERSISTENCE_FORCE_PY")


def _safe_id(source_id: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in source_id)


class _ListReader:
    """Reader facade over pre-fetched records (S3 backend)."""

    def __init__(self, records):
        self.records = records

    def __iter__(self):
        return iter(self.records)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# S3 backend (reference src/persistence/backends/s3.rs:34).
#
# Logs are append-oriented but S3 objects are immutable, so a source's
# log is a GENERATION of objects: {prefix}/g{N}/{seq}.bin, each object a
# run of records in the python log format. The single pointer object
# {prefix}/GEN names the live generation; compaction writes the whole
# compacted log into generation N+1 and then flips the pointer with one
# atomic PUT — a crash between the write and the old-generation cleanup
# leaves only unreferenced garbage, never duplicate records.
# ---------------------------------------------------------------------------


def _pack_record(kind: int, time: int, key: int, blob: bytes) -> bytes:
    body = struct.pack("<BQQI", kind, time, key & 0xFFFFFFFFFFFFFFFF, len(blob)) + blob
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return struct.pack("<I", len(body)) + body + struct.pack("<I", crc)


def _iter_records(buf: bytes) -> Iterator[tuple[int, int, int, bytes]]:
    """Parse packed records; stops at the first torn/corrupt record."""
    off = 0
    n = len(buf)
    while off + 4 <= n:
        (blen,) = struct.unpack_from("<I", buf, off)
        if off + 4 + blen + 4 > n:
            return
        body = buf[off + 4 : off + 4 + blen]
        (crc,) = struct.unpack_from("<I", buf, off + 4 + blen)
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            return
        kind, time, key, plen = struct.unpack_from("<BQQI", body, 0)
        blob = body[21 : 21 + plen]
        if len(blob) != plen:
            return
        yield kind, time, key, bytes(blob)
        off += 4 + blen + 4


class S3LogStorage:
    """Key-value plumbing for one persistence root on an S3-compatible
    store. The client is boto3-shaped (list_objects_v2 / get_object /
    put_object / delete_object) and injectable for tests."""

    def __init__(self, client, bucket: str, root: str):
        self.client = client
        self.bucket = bucket
        self.root = root.strip("/")

    # -- raw object helpers --

    @staticmethod
    def _is_missing_key(e: Exception) -> bool:
        if isinstance(e, (KeyError, FileNotFoundError)):
            return True  # in-memory/disk fakes
        name = type(e).__name__
        if name in ("NoSuchKey", "NoSuchBucket"):
            return True
        code = ""
        resp = getattr(e, "response", None)
        if isinstance(resp, dict):
            code = str(resp.get("Error", {}).get("Code", ""))
        return code in ("NoSuchKey", "NoSuchBucket", "404")

    def _get(self, key: str) -> bytes | None:
        try:
            return self.client.get_object(Bucket=self.bucket, Key=key)["Body"].read()
        except Exception as e:
            # ONLY a missing key maps to None — a transient S3 error
            # must not be mistaken for "no persisted state" (that would
            # orphan the live generation on the next compaction flip)
            if self._is_missing_key(e):
                return None
            raise

    def _put(self, key: str, body: bytes) -> None:
        self.client.put_object(Bucket=self.bucket, Key=key, Body=body)

    def _list(self, prefix: str) -> list[str]:
        keys: list[str] = []
        token = None
        while True:
            kw = {"Bucket": self.bucket, "Prefix": prefix}
            if token:
                kw["ContinuationToken"] = token
            resp = self.client.list_objects_v2(**kw)
            keys.extend(o["Key"] for o in resp.get("Contents", []))
            if not resp.get("IsTruncated"):
                return sorted(keys)
            token = resp.get("NextContinuationToken")

    def _delete(self, key: str) -> None:
        try:
            self.client.delete_object(Bucket=self.bucket, Key=key)
        except Exception:
            pass

    # -- per-source generations --

    def _gen_key(self, source_id: str) -> str:
        return f"{self.root}/{source_id}/GEN"

    def generation(self, source_id: str) -> int:
        body = self._get(self._gen_key(source_id))
        return int(body.decode()) if body else 0

    def _gen_prefix(self, source_id: str, gen: int) -> str:
        return f"{self.root}/{source_id}/g{gen:06d}/"

    def read_records(self, source_id: str) -> list[tuple[int, int, int, bytes]]:
        gen = self.generation(source_id)
        out: list[tuple[int, int, int, bytes]] = []
        for key in self._list(self._gen_prefix(source_id, gen)):
            body = self._get(key)
            if body:
                out.extend(_iter_records(body))
        return out

    def replace_records(
        self, source_id: str, records: Iterable[tuple[int, int, int, bytes]]
    ) -> None:
        """Compaction flip: next generation holds exactly ``records``."""
        old_gen = self.generation(source_id)
        new_gen = old_gen + 1
        buf = bytearray()
        for rec in records:
            buf += _pack_record(*rec)
        if buf:
            self._put(self._gen_prefix(source_id, new_gen) + "00000000.bin", bytes(buf))
        self._put(self._gen_key(source_id), str(new_gen).encode())
        for key in self._list(self._gen_prefix(source_id, old_gen)):
            self._delete(key)

    def writer(self, source_id: str) -> "S3LogWriter":
        gen = self.generation(source_id)
        prefix = self._gen_prefix(source_id, gen)
        existing = self._list(prefix)
        seq = len(existing)
        return S3LogWriter(self, prefix, seq)

    def drop_source(self, source_id: str) -> None:
        self.replace_records(source_id, [])


class S3LogWriter:
    """Buffers appended records; each flush uploads one new object."""

    def __init__(self, storage: S3LogStorage, prefix: str, seq: int):
        self.storage = storage
        self.prefix = prefix
        self.seq = seq
        self.buf = bytearray()

    def append(self, kind: int, time: int, key: int, blob: bytes) -> None:
        self.buf += _pack_record(kind, time, key, blob)

    def flush(self) -> None:
        if not self.buf:
            return
        self.storage._put(f"{self.prefix}{self.seq:08d}.bin", bytes(self.buf))
        self.seq += 1
        self.buf = bytearray()

    def close(self) -> None:
        self.flush()


class EnginePersistence:
    """Per-run persistence manager: owns one log per persistent source
    (reference WorkerPersistentStorage, src/persistence/tracker.rs:49)."""

    def __init__(self, config: Any):
        backend = getattr(config, "backend", None)
        if backend is None:
            raise ValueError("persistence config has no backend")
        self.kind = backend.kind
        self.root = backend.path
        self.events = getattr(backend, "events", None)
        self.config = config
        self._s3: S3LogStorage | None = None
        self._base_root = self.root  # process-0 namespace (delivered marker)
        self._s3_base_prefix: str | None = None
        if self.kind == "filesystem":
            # one namespace per process of the topology — parallel hosts
            # must not share log files (reference WorkerPersistentStorage,
            # src/persistence/tracker.rs:49)
            pid = os.environ.get("PATHWAY_PROCESS_ID")
            if pid and pid != "0":
                self.root = os.path.join(self.root, f"proc-{pid}")
            os.makedirs(os.path.join(self.root, "streams"), exist_ok=True)
        elif self.kind == "mock":
            if self.events is None:
                backend.events = self.events = []
        elif self.kind == "s3":
            # reference src/persistence/backends/s3.rs:34
            bucket, prefix = self._parse_s3_root(backend)
            self._s3_base_prefix = prefix
            pid = os.environ.get("PATHWAY_PROCESS_ID")
            if pid and pid != "0":
                prefix = f"{prefix}/proc-{pid}"
            client = getattr(backend, "client", None)
            if client is None:
                settings = getattr(backend, "bucket_settings", None)
                if settings is None:
                    raise ValueError(
                        "Backend.s3 needs bucket_settings (AwsS3Settings) "
                        "or an injected client"
                    )
                client = settings.create_client()
                if not bucket:
                    bucket = settings.bucket_name
            self._s3 = S3LogStorage(client, bucket, prefix)
        else:
            raise NotImplementedError(
                f"persistence backend {self.kind!r} is not available in this build; "
                "use Backend.filesystem, Backend.s3, or Backend.mock"
            )
        self._writers: dict[str, Any] = {}
        # per-source trim frontier discovered at recovery (KIND_COMPACT)
        self.compacted_to: dict[str, int] = {}
        pid = os.environ.get("PATHWAY_PROCESS_ID")
        if not pid or pid == "0":
            # enrol as the elastic plane's durable token store (weakly held):
            # reshard generation bumps and intents write through the same
            # single-record logs as the cluster generation
            from ..elastic.controller import register_persistence

            register_persistence(self)

    @staticmethod
    def _parse_s3_root(backend) -> tuple[str, str]:
        from ..utils.uri import split_s3_path

        bucket, prefix = split_s3_path(backend.path or "")
        if bucket is None:
            settings = getattr(backend, "bucket_settings", None)
            bucket = getattr(settings, "bucket_name", None) or ""
        return bucket, prefix.strip("/") or "pathway-persistence"

    # -- storage plumbing --

    def _source_path(self, source_id: str) -> str:
        return os.path.join(self.root, "streams", _safe_id(source_id) + ".bin")

    def _mock_bucket(self, source_id: str) -> list:
        # events may be a dict-of-lists keyed by source; a flat list gets
        # source-stamped records instead (MemoryLogWriter)
        if isinstance(self.events, dict):
            return self.events.setdefault(source_id, [])
        return self.events

    def _open_reader(self, source_id: str):
        if self.kind == "mock":
            return MemoryLogReader(self._mock_bucket(source_id), source_id)
        if self.kind == "s3":
            return _ListReader(self._s3.read_records(_safe_id(source_id)))
        return sniff_log_reader(self._source_path(source_id))

    def writer_for(self, source_id: str):
        w = self._writers.get(source_id)
        if w is None:
            if self.kind == "mock":
                w = MemoryLogWriter(self._mock_bucket(source_id), source_id)
            elif self.kind == "s3":
                w = self._s3.writer(_safe_id(source_id))
            elif _use_native():
                w = _native.SnapshotLogWriter(self._source_path(source_id), append=True)
            else:
                w = PyLogWriter(self._source_path(source_id), append=True)
            self._writers[source_id] = w
        return w

    def log_position(self, source_id: str) -> int | None:
        """Current byte position of the source's log writer, if the
        backend exposes one (filesystem logs). Used by the chaos
        harness to script crashes at exact byte offsets. The native
        writer keeps no python-side handle, so fall back to the file
        size — exact at the flush boundaries where chaos sites fire."""
        w = self._writers.get(source_id)
        f = getattr(w, "_f", None)
        if f is not None:
            try:
                return f.tell()
            except (OSError, ValueError):
                return None
        if w is not None and self.kind == "filesystem":
            try:
                return os.path.getsize(self._source_path(source_id))
            except OSError:
                return None
        return None

    # -- engine API --

    def recover_source(self, source_id: str, delivered_frontier: int = -1):
        """Read a source's log. Returns ``(batches, offsets, frontier)``:
        time-ordered finalized update batches, the reader offsets at the
        last ADVANCE, and the finalized frontier (-1 when fresh).

        ``delivered_frontier``: process 0's durable record of the last
        epoch whose output reached the sinks. Epochs this worker fed
        (KIND_FEED present) but never ADVANCEd are promoted to finalized
        when they are at or below it — they were delivered, so replaying
        them as fresh input would deliver twice."""
        import pickle

        reader = self._open_reader(source_id)
        if reader is None:
            return [], {}, -1
        by_time: dict[int, list] = {}
        offsets: dict = {}
        feed_offsets: dict[int, dict] = {}
        frontier = -1
        compacted_to = -1
        try:
            for kind, time, key, blob in reader:
                if kind == KIND_DATA:
                    row, diff = pickle.loads(blob)
                    by_time.setdefault(time, []).append((key, row, diff))
                elif kind == KIND_ADVANCE:
                    frontier = max(frontier, time)
                    offsets = pickle.loads(blob)
                elif kind == KIND_FEED:
                    feed_offsets[time] = pickle.loads(blob)
                elif kind == KIND_COMPACT:
                    compacted_to = max(compacted_to, time)
        finally:
            reader.close()
        for t in sorted(feed_offsets):
            if frontier < t <= delivered_frontier:
                frontier = t
                offsets = feed_offsets[t]
        self.compacted_to[source_id] = compacted_to
        batches = sorted((t, ups) for t, ups in by_time.items() if t <= frontier)
        # Compact the log down to exactly the finalized records before any
        # new writes. This (a) drops orphaned DATA past the last ADVANCE —
        # the reader re-produces that input, and appending the re-read at
        # the same epoch would double it on the NEXT recovery; (b) heals a
        # torn tail so post-crash appends stay reachable; (c) normalizes
        # the on-disk format to the writer this process will append with.
        # The analog of the reference's snapshot compaction
        # (src/persistence/operator_snapshot.rs:491).
        if self.kind == "filesystem":
            self._rewrite_log(source_id, batches, offsets, frontier, compacted_to)
        elif self.kind == "s3":
            self._s3.replace_records(
                _safe_id(source_id),
                self._records_for(batches, offsets, frontier, compacted_to),
            )
        else:
            self._compact_mock(source_id, frontier)
        return batches, offsets, frontier

    @staticmethod
    def _records_for(batches, offsets, frontier: int, compacted_to: int = -1):
        import pickle

        if frontier < 0:
            return []
        recs = [
            (KIND_DATA, t, key, pickle.dumps((row, diff), protocol=4))
            for t, ups in batches
            for key, row, diff in ups
        ]
        recs.append(
            (KIND_ADVANCE, frontier, 0, pickle.dumps(offsets or {}, protocol=4))
        )
        if compacted_to >= 0:
            recs.append((KIND_COMPACT, compacted_to, 0, b""))
        return recs

    def compact_inputs(self, source_ids, t: int) -> None:
        """Trim every given source's log below an operator snapshot at
        ``t`` (engine hook after save_operator_snapshot)."""
        for sid in source_ids:
            self.compact_source_below(sid, int(t))

    def check_compaction_covered(self, source_ids, restored_t) -> None:
        """Fail loudly when any input log was snapshot-compacted and the
        restored snapshot (restored_t; None = none restored) does not
        cover the trimmed range — every other path would silently replay
        a partial log (changed program, lost snapshot, speedrun, mixed
        persistence)."""
        max_compacted = max(
            (self.compacted_to.get(sid, -1) for sid in source_ids),
            default=-1,
        )
        if max_compacted >= 0 and (restored_t is None or restored_t < max_compacted):
            raise RuntimeError(
                "the persisted input logs were snapshot-compacted, but no "
                "compatible operator snapshot covering the trimmed range "
                "could be restored (changed program, missing snapshot, "
                "speedrun replay, or non-persistent sources added) — "
                "clear the persistence root or run the original program"
            )

    def compact_source_below(self, source_id: str, t0: int) -> None:
        """Drop finalized DATA <= t0 — an operator snapshot at t0 covers
        it — so input logs stay bounded on long-running jobs (the role
        of the reference's background snapshot compaction,
        src/persistence/operator_snapshot.rs:491). A KIND_COMPACT marker
        records the trim so recovery into a changed program (which would
        need the dropped input) fails loudly instead of silently
        computing from a partial log."""
        import pickle

        w = self._writers.pop(source_id, None)
        if w is not None:
            try:
                w.flush()
            finally:
                w.close()
        if self.kind == "mock":
            bucket = self._mock_bucket(source_id)
            keep = []
            for rec in bucket:
                sid, kind, time = (
                    (rec[0], rec[1], rec[2]) if len(rec) == 5 else (source_id, rec[0], rec[1])
                )
                if sid == source_id and kind == KIND_DATA and time <= t0:
                    continue
                keep.append(rec)
            bucket[:] = keep
            MemoryLogWriter(bucket, source_id).append(KIND_COMPACT, int(t0), 0, b"")
            self.compacted_to[source_id] = max(
                self.compacted_to.get(source_id, -1), int(t0)
            )
            return
        # re-read, filter, rewrite (file/s3)
        reader = self._open_reader(source_id)
        if reader is None:
            return
        by_time: dict[int, list] = {}
        offsets: dict = {}
        frontier = -1
        try:
            for kind, time, key, blob in reader:
                if kind == KIND_DATA and time > t0:
                    row, diff = pickle.loads(blob)
                    by_time.setdefault(time, []).append((key, row, diff))
                elif kind == KIND_ADVANCE:
                    frontier = max(frontier, time)
                    offsets = pickle.loads(blob)
        finally:
            reader.close()
        batches = sorted(by_time.items())
        if self.kind == "s3":
            self._s3.replace_records(
                _safe_id(source_id),
                self._records_for(batches, offsets, frontier, int(t0)),
            )
        else:
            self._rewrite_log(source_id, batches, offsets, frontier, int(t0))
        self.compacted_to[source_id] = max(
            self.compacted_to.get(source_id, -1), int(t0)
        )

    def _rewrite_log(
        self, source_id: str, batches, offsets, frontier: int, compacted_to: int = -1
    ) -> None:
        path = self._source_path(source_id)
        if frontier < 0:
            if os.path.exists(path):
                os.remove(path)
            return
        tmp = path + ".compact"
        if _use_native():
            w = _native.SnapshotLogWriter(tmp, append=False)
        else:
            w = PyLogWriter(tmp, append=False)
        for rec in self._records_for(batches, offsets, frontier, compacted_to):
            w.append(*rec)
        w.flush()
        w.close()
        os.replace(tmp, path)

    def _compact_mock(self, source_id: str, frontier: int) -> None:
        bucket = self._mock_bucket(source_id)
        keep = []
        for rec in bucket:
            sid, kind, time = (rec[0], rec[1], rec[2]) if len(rec) == 5 else (source_id, rec[0], rec[1])
            if sid == source_id and kind == KIND_DATA and time > frontier:
                continue  # orphaned: never finalized
            keep.append(rec)
        bucket[:] = keep

    def log_batch(
        self, source_id: str, time: int, updates: list, offsets: dict | None = None
    ) -> None:
        import pickle

        from ..resilience import chaos

        w = self.writer_for(source_id)
        # the byte offset (a stat of the log) only when a chaos rule targets the site
        armed = chaos.armed("persistence.append_data")
        for key, row, diff in updates:
            w.append(KIND_DATA, time, key, pickle.dumps((row, diff), protocol=4))
            if armed:
                chaos.inject("persistence.append_data", time=int(time), offset=self.log_position(source_id))
        if offsets is not None:
            # feed-time offsets: durable BEFORE process 0 can deliver the
            # epoch, so a crash between p0's sink flush and this worker's
            # ADVANCE leaves enough on disk to finalize the epoch on
            # recovery (see recover_source delivered_frontier)
            w.append(KIND_FEED, time, 0, pickle.dumps(offsets or {}, protocol=4))
            w.flush()
            flight_recorder.record(
                "feed.commit", source=source_id, t=int(time), rows=len(updates)
            )

    def advance(self, source_id: str, time: int, offsets: dict) -> None:
        import pickle

        from ..resilience import chaos

        chaos.inject(
            "persistence.before_advance",
            time=int(time),
            offset=self.log_position(source_id),
        )
        w = self.writer_for(source_id)
        w.append(KIND_ADVANCE, time, 0, pickle.dumps(offsets or {}, protocol=4))
        w.flush()
        flight_recorder.record("offsets.advance", source=source_id, t=int(time))

    OPS_SOURCE = "__operators__"
    DELIVERED_SOURCE = "__delivered__"
    CLUSTER_SOURCE = "__cluster__"
    ELASTIC_SOURCE = "__elastic__"

    def mark_delivered(self, time: int) -> None:
        """Process 0 only: durably record that sinks flushed epoch
        ``time`` — written after the sink flush, before workers are told
        to advance their offset cursors. Workers consult this marker on
        recovery (``delivered_frontier``) to finalize fed-but-unadvanced
        epochs instead of re-delivering them."""
        w = self.writer_for(self.DELIVERED_SOURCE)
        w.append(KIND_ADVANCE, int(time), 0, b"")
        w.flush()
        flight_recorder.record("epoch.delivered", t=int(time))
        self._delivered_appends = getattr(self, "_delivered_appends", 0) + 1
        if self._delivered_appends >= 4096:
            # bound the marker log: only the max time matters
            old = self._writers.pop(self.DELIVERED_SOURCE, None)
            if old is not None:
                old.close()
            self._replace_single_record(
                self.DELIVERED_SOURCE, (KIND_ADVANCE, int(time), 0, b"")
            )
            self._delivered_appends = 0

    def delivered_frontier(self) -> int:
        """Last epoch process 0 durably delivered (-1 when none). Read
        from the process-0 namespace so worker processes see it too."""
        reader = self._open_reader_base(self.DELIVERED_SOURCE)
        if reader is None:
            return -1
        frontier = -1
        try:
            for kind, time, _key, _blob in reader:
                if kind == KIND_ADVANCE:
                    frontier = max(frontier, time)
        finally:
            reader.close()
        return frontier

    def cluster_generation(self) -> int:
        """Current cluster epoch-generation token (0 when none was ever
        written). Read from the process-0 namespace so every worker
        sees the coordinator's bumps; the coordinator stamps it into
        hellos/welcomes and rejects protocol frames carrying an older
        one (zombie fencing after a partial restart)."""
        reader = self._open_reader_base(self.CLUSTER_SOURCE)
        if reader is None:
            return 0
        gen = 0
        try:
            for kind, time, _key, _blob in reader:
                if kind == KIND_ADVANCE:
                    gen = max(gen, int(time))
        finally:
            reader.close()
        return gen

    def bump_cluster_generation(self) -> int:
        """Coordinator only: durably advance the generation at the start
        of a partial restart. A single-record log, like the compacted
        delivered marker — only the latest token matters."""
        gen = self.cluster_generation() + 1
        self._writers.pop(self.CLUSTER_SOURCE, None)
        self._replace_single_record(
            self.CLUSTER_SOURCE, (KIND_ADVANCE, gen, 0, b"")
        )
        flight_recorder.record("cluster.generation", generation=gen)
        return gen

    def record_reshard_intent(self, target_shards: int, generation: int) -> None:
        """Durably declare an in-flight elastic reshard: a single-record
        log carrying (generation, target shard count). Written AFTER the
        generation bump and cleared only once the cutover committed, so
        a crash at any chunk/cutover boundary leaves an intent behind
        and recovery (``elastic.recover_pending_reshard``) can decide
        complete-vs-rollback deterministically."""
        self._writers.pop(self.ELASTIC_SOURCE, None)
        self._replace_single_record(
            self.ELASTIC_SOURCE,
            (KIND_ADVANCE, int(generation), int(target_shards), b""),
        )
        flight_recorder.record(
            "elastic.intent",
            generation=int(generation),
            target_shards=int(target_shards),
        )

    def reshard_intent(self) -> tuple[int, int] | None:
        """The pending (target_shards, generation) reshard intent, or
        None when the last reshard committed (or none ever ran). Read
        from the process-0 namespace like the generation token."""
        reader = self._open_reader_base(self.ELASTIC_SOURCE)
        if reader is None:
            return None
        out = None
        try:
            for kind, time, key, _blob in reader:
                if kind == KIND_ADVANCE:
                    out = (int(key), int(time))
        finally:
            reader.close()
        return out

    def clear_reshard_intent(self) -> None:
        self._writers.pop(self.ELASTIC_SOURCE, None)
        self._replace_single_record(self.ELASTIC_SOURCE, None)

    def _open_reader_base(self, source_id: str):
        """Open a source log in the PROCESS-0 namespace regardless of
        this process's own proc-<pid> namespace."""
        if self.kind == "mock":
            return MemoryLogReader(self._mock_bucket(source_id), source_id)
        if self.kind == "s3":
            assert self._s3 is not None
            base = S3LogStorage(
                self._s3.client, self._s3.bucket, self._s3_base_prefix or ""
            )
            return _ListReader(base.read_records(_safe_id(source_id)))
        path = os.path.join(
            self._base_root, "streams", _safe_id(source_id) + ".bin"
        )
        return sniff_log_reader(path)

    def _replace_single_record(
        self, source_id: str, record: tuple[int, int, int, bytes] | None
    ) -> None:
        """Atomically make a source's log hold exactly ``record``
        ((kind, time, key, blob)) — or nothing. Shared by the
        snapshot-save and recovery-compaction paths."""
        if self.kind == "mock":
            bucket = self._mock_bucket(source_id)
            bucket[:] = [
                r for r in bucket if not (len(r) == 5 and r[0] == source_id)
            ]
            if record is not None:
                MemoryLogWriter(bucket, source_id).append(*record)
            return
        if self.kind == "s3":
            self._writers.pop(source_id, None)
            self._s3.replace_records(
                _safe_id(source_id), [] if record is None else [record]
            )
            return
        path = self._source_path(source_id)
        if record is None:
            if os.path.exists(path):
                os.remove(path)
            return
        tmp = path + ".compact"
        if _use_native():
            w = _native.SnapshotLogWriter(tmp, append=False)
        else:
            w = PyLogWriter(tmp, append=False)
        w.append(*record)
        w.flush()
        w.close()
        os.replace(tmp, path)

    def save_operator_snapshot(self, time: int, blob: bytes) -> None:
        """Write the whole-graph operator snapshot (layer 2 of the
        reference's persistence, operator_snapshot.rs). Only the latest
        snapshot is ever read, so each save REPLACES the log — appending
        would grow it by full-state-size per interval, unbounded."""
        self._replace_single_record(self.OPS_SOURCE, (KIND_OPSNAP, int(time), 0, blob))

    def recover_operator_snapshot(self, max_time: int):
        """Latest snapshot finalized at or before ``max_time`` (the input
        frontier — a snapshot can never cover unfinalized input, see the
        write ordering in EngineGraph.run). Returns (time, blob) or
        None; compacts the log down to the returned record."""
        reader = self._open_reader(self.OPS_SOURCE)
        if reader is None:
            return None
        best = None
        try:
            for kind, time, _key, blob in reader:
                if kind == KIND_OPSNAP and time <= max_time:
                    if best is None or time >= best[0]:
                        best = (time, blob)
        finally:
            reader.close()
        # compact: orphaned/stale snapshots never need a second read
        self._replace_single_record(
            self.OPS_SOURCE,
            None if best is None else (KIND_OPSNAP, best[0], 0, best[1]),
        )
        return best

    def reset_source(self, source_id: str) -> None:
        """Drop a source's log (record mode, offset-unaware reader: the
        reader re-produces all input, so recording starts over)."""
        if self.kind == "mock":
            bucket = self._mock_bucket(source_id)
            bucket[:] = [r for r in bucket if not (len(r) == 5 and r[0] == source_id)]
            if isinstance(self.events, dict):
                bucket.clear()
            return
        if self.kind == "s3":
            self._writers.pop(source_id, None)
            self._s3.drop_source(_safe_id(source_id))
            return
        path = self._source_path(source_id)
        if os.path.exists(path):
            os.remove(path)

    def close(self) -> None:
        for w in self._writers.values():
            try:
                w.close()
            except Exception:
                pass
        self._writers.clear()
