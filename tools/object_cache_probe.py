"""Time the port's object cache writes on this machine's filesystem.

    python tools/object_cache_probe.py [N]

``ObjectCache.put`` (a ``.meta`` removed, then a ``.bin`` and a ``.meta``
each written to a temporary file and renamed over the old one) for N keys
one by one and from a pool of 8 threads, then the file operations it is
made of, each N times: a file created, written and closed; a rename; the
removal of a missing file. Prints one JSON line of milliseconds an
operation. Runs in the temporary directory, which it cleans up.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pathway_tpu_torch.io._object_store import ObjectCache  # noqa: E402

PAYLOAD = b"word " * 120  # a 600-byte object, the size of a 120-word text


def per_op_ms(fn, n: int) -> float:
    t = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t) / n * 1e3


def main(n: int) -> dict:
    root = tempfile.mkdtemp(prefix="object-cache-probe-")
    try:
        out = {"n": n, "dir": os.path.dirname(root)}
        cache = ObjectCache(os.path.join(root, "one"))
        out["put_ms"] = per_op_ms(lambda i: cache.put(f"k{i}", '"e"', PAYLOAD), n)
        out["get_hit_ms"] = per_op_ms(lambda i: cache.get(f"k{i}", '"e"'), n)
        pooled = ObjectCache(os.path.join(root, "pool"))
        t = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda i: pooled.put(f"k{i}", '"e"', PAYLOAD), range(n)))
        out["put_8_threads_ms"] = (time.perf_counter() - t) / n * 1e3
        files = os.path.join(root, "files")
        os.makedirs(files)

        def create(i):
            fd = os.open(os.path.join(files, f"a{i}"), os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
            os.write(fd, PAYLOAD)
            os.close(fd)

        def remove_missing(i):
            try:
                os.remove(os.path.join(files, f"missing{i}"))
            except OSError:
                pass

        out["create_write_close_ms"] = per_op_ms(create, n)
        out["rename_ms"] = per_op_ms(lambda i: os.replace(os.path.join(files, f"a{i}"), os.path.join(files, f"b{i}")), n)
        out["remove_missing_ms"] = per_op_ms(remove_missing, n)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1 else 2000)))
