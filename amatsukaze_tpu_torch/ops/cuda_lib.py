"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``ops/build/`` (git-ignored) and loaded with ``ctypes``. The library name
carries a digest of the source and the flags (a caller may add some, such
as a ``-D`` that turns a kernel's instrumentation on), so an edited source
is rebuilt and a stale library is never loaded. Nothing is built when a
module is imported: the CPU tests import every module and have no
``nvcc``.
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

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or
    the one on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str, extra_flags=()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join((*NVCC_FLAGS, *extra_flags))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names, extra_flags=()) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns {name: seconds} for the ones
    built; the ptxas register/shared-memory report of each lands in
    ``build/<name>.log`` (``build/<name>.flags.log`` with extra flags).
    Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name, extra_flags)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        log_name = f"{name}.flags.log" if extra_flags else f"{name}.log"
        (BUILD_DIR / log_name).write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str, extra_flags=()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    key = (name, tuple(extra_flags))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build([name], extra_flags)
            lib = ctypes.CDLL(str(library_path(name, extra_flags)))
            _libs[key] = lib
        return lib
