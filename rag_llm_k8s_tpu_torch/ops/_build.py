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

``COMPILES`` tallies the library builds and first loads of this process (the
CUDA kernels here and the C++ host libraries of ``native/build.py``): the
port compiles nothing per shape, so these are its "first request is slow"
cost, which the engines serve as ``rag_compile_events_total`` and
``rag_compile_seconds_total``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

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

# wrapper -> (kernel templates, KV type): the one kernel of ``csrc/`` each
# wrapper call issues besides an optional merge pass (the kNN's merge pass is
# its one), as a device trace names it; ``tools/trace_summary.py`` matches
# trace events to LAUNCHES with it
KERNEL_NAMES: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "knn_topk": (("knn_merge_parts",), ""),
    "flash_attention": (("chunk_kernel", "ws_kernel"), "StridedKV"),
    "decode_attention": (("decode_kernel",), "DenseKV"),
    "chunk_prefill_attention": (("chunk_kernel", "ws_kernel"), "DenseKV"),
    "paged_decode_attention": (("decode_kernel",), "PagedKV"),
    "paged_chunk_attention": (("chunk_kernel", "ws_kernel"), "PagedKV"),
    "decode_attention_q8": (("decode_q8_kernel",), "DenseQ8"),
    "chunk_prefill_attention_q8": (("chunk_q8_kernel",), "DenseQ8"),
    "paged_decode_attention_q8": (("decode_q8_kernel",), "PagedQ8"),
    "paged_chunk_attention_q8": (("chunk_q8_kernel",), "PagedQ8"),
}

# knn_topk launches by query count (a pass of 8 is a coalesced burst's
# retrieve, a pass of 1 a solo query's), counted with LAUNCHES["knn_topk"]
KNN_LAUNCHES_BY_QUERIES: Dict[int, int] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# library builds and first loads in this process, and their wall seconds
COMPILES: Dict[str, float] = {"events": 0, "seconds": 0.0}
_compiles_lock = threading.Lock()


def record_compile(seconds: float, events: int = 1) -> None:
    with _compiles_lock:
        COMPILES["events"] += events
        COMPILES["seconds"] += seconds


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
    t0 = time.perf_counter()
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
    if reports:
        record_compile(time.perf_counter() - t0, events=len(reports))
    return reports


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed, with
    ``signatures`` (``{symbol: (argtypes, restype)}``) declared on first load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            t0 = time.perf_counter()
            lib = ctypes.CDLL(_target(name))
            for sym, (argtypes, restype) in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes, fn.restype = argtypes, restype
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
            record_compile(time.perf_counter() - t0)
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the ``n_sm`` of
    the kernels' launch plans."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check_no_grad(what: str, *tensors) -> None:
    """Raise when autograd would record a kernel call: the kernels have no
    backward, and the output of a ``ctypes`` launch has no ``grad_fn``, so
    the gradient would stop there without a word. Train through the plain
    versions (``models.llama`` ``attn_impl="xla"``)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward and an input requires grad; "
                           "train through the plain version (attn_impl='xla')")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a kernel's C entry point returns a CUDA error."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch ({msg})")
