"""Build the package's CUDA kernels and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
under ``build/kernels/`` at the checkout's root, at first use.  Library
names carry a hash of the source and the flags, so an edited source
rebuilds and a stale library is never loaded.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for all of them.

Every C entry point takes each pointer and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
nonzero code into a ``RuntimeError`` with CUDA's own message.  Nothing
here runs at import: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = [
    "SOURCES",
    "BUILD_DIR",
    "NVCC_FLAGS",
    "nvcc_path",
    "build",
    "load",
    "check",
    "count_launch",
    "build_log",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/kernels: this file is <checkout>/src/repro_torch/kernels/_build.py
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("huffdecode", "unplane", "plane", "bitpack", "xor_delta", "histogram", "bytegroup")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}        # nvcc/ptxas output per library built here


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet.

    All ``nvcc`` processes start together; a failed compile raises with
    the compiler's output.  Returns the library path per name.
    """
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first when missing)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(name: str, code: int, what: str) -> None:
    """Raise when a C entry point of library ``name`` returned an error."""
    if code:
        msg: Optional[bytes] = getattr(_libs[name], f"{name}_error_string")(code)
        text = msg.decode() if msg else "unknown error"
        raise RuntimeError(f"{what}: CUDA error {code} ({text})")


def count_launch(fn, path: Optional[str] = None) -> None:
    """Add one to a wrapper's ``launches`` (and to ``launches_by_path[path]``
    when the wrapper counts its kernel's paths).  Frames of the file engine
    and saves of the checkpoint manager launch from worker threads, and
    ``+=`` on an attribute is not atomic."""
    with _count_lock:
        fn.launches += 1
        if path is not None:
            fn.launches_by_path[path] += 1
