"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/pathway_tpu_torch/``
at the repository root, and is bound through ``ctypes``. A library is built
at first use on a CUDA tensor (never at import) and cached by the hash of
its source, of every ``csrc/*.cuh`` header and of the flags, so an edited
source or header never reuses a stale library. No source links anything
beyond the CUDA runtime: ``gemm_epilogue.cu`` fetches the driver's
``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint*``. ``build_all``
starts one ``nvcc`` per source at once. Every C entry point returns its
``cudaError_t``; :func:`check` raises when it is not 0.

``LAUNCHES`` counts kernel launches by name: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels the
main path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pathway_tpu_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# source file -> {C entry point: argtypes}
SOURCES: dict[str, dict[str, tuple]] = {
    "gemm_epilogue.cu": {
        "pt_gemm_bias_act": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        "pt_gemm_bias_residual_layernorm": (
            _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P,
        ),
    },
    "masked_attention.cu": {
        "pt_masked_attention": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    },
    "segment_attention.cu": {
        "pt_segment_attention": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    },
    "paged_decode_attention.cu": {
        "pt_paged_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "knn_topk.cu": {
        "pt_knn_topk_stream": (_P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
        "pt_knn_topk_tc": (_P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _P, _P, _P),
        "pt_knn_topk_merge": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    },
}

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from csrc/ at first "
        "use on a CUDA tensor and need the CUDA toolkit"
    )


def _lib_path(source: str) -> str:
    """The library's path, keyed by the source, every header in ``csrc/``
    (a source may include any of them) and the flags."""
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{source[:-3]}-{h.hexdigest()[:16]}.so")


def _start_build(source: str) -> tuple[subprocess.Popen, str, str] | None:
    out = _lib_path(source)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(source: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)


def _bind(source: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(_lib_path(source))
    for name, argtypes in SOURCES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_all() -> None:
    """Build every kernel source in parallel (one nvcc each) and bind them."""
    with _LOCK:
        todo = [s for s in SOURCES if s not in _LIBS]
        started = [(s, _start_build(s)) for s in todo]
        for s, st in started:
            _finish_build(s, st)
        for s in todo:
            _LIBS[s] = _bind(s)


def library(source: str) -> ctypes.CDLL:
    """The bound library of one source, built on first use."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _LOCK:
        if source not in _LIBS:
            _finish_build(source, _start_build(source))
            _LIBS[source] = _bind(source)
        return _LIBS[source]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def stream_handle(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the integer the C
    entry points take."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, *, dtype, ndim: int, name: str) -> None:
    """Wrapper-side checks for a kernel operand: dtype, rank, contiguity and
    16-byte alignment (the kernels load 16 bytes at a time). The device is
    the wrapper's to check: it launches only for a CUDA first operand and
    raises unless every other operand lies on that device."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
