"""Build and load the port's CUDA kernels.

Each ``paddlebox_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into a
shared library with a plain C interface, ``build/lib<name>-<digest>.so`` at
the root of the checkout, which the wrapper loads with ``ctypes``. The
digest covers the source and the flags, so an edited source never loads a
stale library. Building happens at first use (or up front through
``build``) and needs only the sources in the repository and the CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME): the port's kernels build from "
                       "source at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(name: str) -> Optional[Tuple[float, str]]:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns
    ``(seconds, compiler log)`` when it compiled, else None."""
    dst = library_path(name)
    if dst.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{res.returncode}\n{res.stdout}")
    os.replace(tmp, dst)
    return time.perf_counter() - t0, res.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
