"""Build and load the port's native libraries and its one executable.

Three routes:

- ``paddlebox_tpu_torch/csrc/<name>.cu``, a CUDA kernel, compiles with
  ``nvcc`` for ``sm_90a``;
- ``paddlebox_tpu_torch/csrc/<name>.cpp``, host code (the key index, the
  file tokenizer), compiles with ``g++ -march=native``;
- the names in :data:`EXECUTABLES` (``pbx_serve``, the embedded serving
  loader) compile with ``g++`` into ``build/<name>-<digest>``, a program
  against PyTorch's C++ library and the CUDA toolkit's headers
  (``torch.utils.cpp_extension``'s include and library paths, torch's
  ``_GLIBCXX_USE_CXX11_ABI``, an rpath to torch's ``lib/``), beside the
  libraries it loads, whose file names are compiled in.

Each library has a plain C interface, ``build/lib<name>-<digest>.so`` at
the root of the checkout, which its wrapper loads with ``ctypes``. The
digest covers the source and the flags, and for ``g++`` also the
compiler's version and the machine (for the executable also torch's
version and its libraries' names), so an edited source, or a
``-march=native`` binary from another machine, never loads stale. A build
writes a temporary file and renames it into place, so processes that build
one target at once are safe. Building happens at first use (or up front
through ``build``) and needs only the sources in the repository and the
compilers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native")
EXE_FLAGS = ("-O2", "-std=c++17", "-pthread")

#: executables and the libraries each loads from beside itself, in the
#: order of its ``-D`` names
EXECUTABLES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "pbx_serve": (("PBX_INDEX_LIB", "pbx_index"),
                  ("PBX_KERNEL_LIB", "seqpool_cvm")),
}

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


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host libraries build "
                           "from source at first use")
    return gxx


@functools.lru_cache(maxsize=None)
def _gxx_id() -> str:
    """The g++ version and the machine, part of a host library's digest:
    the target options that ``-march=native`` turns on name the CPU's
    instruction sets."""
    gxx = _gxx()
    ver = subprocess.run([gxx, "-dumpfullversion", "-dumpversion"],
                         capture_output=True, text=True).stdout.strip()
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    return f"|{ver}|{platform.machine()}|{target}"


def source(name: str) -> Path:
    """``csrc/<name>.cu`` or ``csrc/<name>.cpp``, whichever exists."""
    for suffix in (".cu", ".cpp"):
        path = CSRC / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no source {name}.cu or {name}.cpp in {CSRC}")


@functools.lru_cache(maxsize=None)
def _torch_flags() -> Tuple[str, ...]:
    """The executable route's compile and link flags: PyTorch's headers
    and libraries and the CUDA toolkit's headers (``cpp_extension``'s
    paths for ``cuda``), the C++ ABI torch was built with, an rpath to
    torch's ``lib/``."""
    import torch
    from torch.utils import cpp_extension
    torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return (*(f"-I{p}" for p in cpp_extension.include_paths("cuda")),
            f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
            *(f"-L{p}" for p in cpp_extension.library_paths("cuda")),
            f"-Wl,-rpath,{torch_lib}",
            # the CUDA backend registers itself when libtorch_cuda loads:
            # keep the libraries whose symbols the loader does not name
            "-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-ltorch_cuda",
            "-lc10", "-lc10_cuda", "-Wl,--as-needed", "-ldl")


def _exe_defines(name: str) -> Tuple[str, ...]:
    return tuple(f'-D{macro}="{library_path(lib).name}"'
                 for macro, lib in EXECUTABLES[name])


def _command(name: str, src: Path, out: Path) -> List[str]:
    if name in EXECUTABLES:
        return [_gxx(), *EXE_FLAGS, *_exe_defines(name), str(src), "-o",
                str(out), *_torch_flags()]
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [_gxx(), *GXX_FLAGS, str(src), "-o", str(out)]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>`` builds: ``build/lib<name>-<digest>.so``, or
    ``build/<name>-<digest>`` for an executable."""
    src = source(name)
    if name in EXECUTABLES:
        import torch
        key = " ".join((*EXE_FLAGS, *_exe_defines(name))) + _gxx_id() + \
            torch.__version__
    elif src.suffix == ".cu":
        key = " ".join(NVCC_FLAGS)
    else:
        key = " ".join(GXX_FLAGS) + _gxx_id()
    digest = hashlib.sha256(src.read_bytes() + key.encode()).hexdigest()
    if name in EXECUTABLES:
        return BUILD_DIR / f"{name}-{digest[:12]}"
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(name: str) -> Optional[Tuple[float, str]]:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless it is built already
    (an executable's libraries first). Returns ``(seconds, compiler
    log)`` when it compiled, else None."""
    for _macro, lib in EXECUTABLES.get(name, ()):
        build(lib)
    src = source(name)
    dst = library_path(name)
    if dst.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_name(
        f"{dst.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = _command(name, src, tmp)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build failed: {name}: {Path(cmd[0]).name} "
                           f"exited {res.returncode}\n{res.stdout}")
    os.replace(tmp, dst)
    return time.perf_counter() - t0, res.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
