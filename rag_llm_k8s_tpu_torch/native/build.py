"""Build-at-first-use of the port's C++ host libraries (``bpe.cpp``, the BPE
merge loop; ``indexio.cpp``, the index snapshot codec), loaded with ctypes.

Each ``<name>.cpp`` compiles with ``g++ -O2 -std=c++17 -shared -fPIC`` into
``_build/lib<name>-<hash>.so`` beside this file (listed in ``.gitignore``),
named by a hash of its source as ``ops/_build.py`` names the CUDA kernels,
so an edited source rebuilds and a stale library is never loaded. A failed
build is logged and returns None; each caller says what it does then.
Builds and first loads count into ``ops._build.COMPILES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from typing import Dict, Optional

from rag_llm_k8s_tpu_torch.ops._build import record_compile

logger = logging.getLogger(__name__)

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(SRC_DIR, "_build")
SOURCES = ("bpe", "indexio")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def target(name: str) -> str:
    """The library path for ``<name>.cpp``, named by a hash of its source."""
    with open(os.path.join(SRC_DIR, f"{name}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile ``<name>.cpp`` unless its library exists; returns its path.
    Raises with the compiler's output when ``g++`` fails."""
    out = target(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)
    record_compile(time.perf_counter() - t0)
    logger.info("built native library %s", out)
    return out


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """The loaded ``lib<name>``, built first if needed; None (logged) when it
    cannot be built or loaded."""
    with _lock:
        if name in _libs:
            return _libs[name]
        try:
            path = build(name)
            t0 = time.perf_counter()
            lib = ctypes.CDLL(path)
            record_compile(time.perf_counter() - t0)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native %s unavailable (%s)", name, e)
            lib = None
        _libs[name] = lib
        return lib
