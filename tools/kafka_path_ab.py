"""Time ``chip_smoke.py``'s ``kafka_path`` of one or more checkouts on one card, in turns.

    python tools/kafka_path_ab.py TREE [TREE ...]

For each TREE in the order given (``.`` and an unpacked parent, say,
as ``PARENT . . PARENT``), a process of its own imports that checkout's
``chip_smoke.py`` and port, builds the kernels, warms up ``http_path``'s
embedder (MiniLM-L6, seeded weights) and runs ``phase_kafka_path`` once,
which prints its own JSON line and raises if a gate fails. After it, one
line ``{"tree": TREE, "seconds": ...}``: the path's seconds, from its
first record to its last gate. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

_CHILD = r"""
import os, sys, time
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np
import torch
import chip_smoke as cs
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
torch.backends.cuda.matmul.allow_tf32 = False
env = cs.phase_env(torch)
cs.phase_build()
embedder = SentenceTransformerEmbedder(device="cuda")
embedder._encoder.encode_device(cs._synthetic_texts_bulk(np.random.default_rng(0), 256, 20, 220), pad_to=256)
t = time.perf_counter()
cs.phase_kafka_path(torch, env, embedder)
print("SECONDS", time.perf_counter() - t, flush=True)
"""


def main(trees: list[str]) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD, tree], capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        seconds = float(proc.stdout.rsplit("SECONDS", 1)[1].split()[0])
        print(json.dumps({"tree": tree, "seconds": seconds, "at": time.time()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
