"""Build-at-first-use of the hand-written Hopper kernels, and their launch counts.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The library
name carries a hash of its source, so an edited kernel rebuilds and a stale
one is never loaded. Builds go to ``_build/`` beside this file (listed in
``.gitignore``); a failed build raises with the compiler's output. There is
no fallback: a CUDA tensor reaches its kernel or the caller gets the error.

``LAUNCHES`` counts, per kernel, the launches made through its wrapper. A
run resets it with ``reset_launches()`` and reads it afterwards to show that
the path it drove went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
KERNEL_SOURCES = ("knn", "attention", "attention_sm90", "paged_attention", "attention_q8")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {
    "knn_topk": 0,
    "flash_attention": 0,
    "decode_attention": 0,
    "chunk_prefill_attention": 0,
    "paged_decode_attention": 0,
    "paged_chunk_attention": 0,
    "decode_attention_q8": 0,
    "chunk_prefill_attention_q8": 0,
    "paged_decode_attention_q8": 0,
    "paged_chunk_attention_q8": 0,
}

# knn_topk launches by query count (a pass of 8 is a coalesced burst's
# retrieve, a pass of 1 a solo query's), counted with LAUNCHES["knn_topk"]
KNN_LAUNCHES_BY_QUERIES: Dict[int, int] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    KNN_LAUNCHES_BY_QUERIES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> str:
    """The library path for ``csrc/<name>.cu``, named by a hash of the
    source and of every shared header in ``csrc/``."""
    h = hashlib.sha256()
    for src in [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile the named sources (all started together, one ``nvcc`` each)
    and return ``{name: ptxas report}``; sources already built are skipped."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed, with
    ``signatures`` (``{symbol: (argtypes, restype)}``) declared on first load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name))
            for sym, (argtypes, restype) in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes, fn.restype = argtypes, restype
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the ``n_sm`` of
    the kernels' launch plans."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a kernel's C entry point returns a CUDA error."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch ({msg})")
