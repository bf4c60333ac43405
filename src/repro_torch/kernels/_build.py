"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Every ``csrc/*.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it into a shared library in seconds.  A source may include
the shared headers ``csrc/*.cuh`` (``-I`` points at ``csrc``).  The library
goes into ``build/repro_torch/`` at the repository root, named by a hash
of the source, every shared header and the flags, at first use -- so
editing a header rebuilds every library; what nvcc printed (the
``-Xptxas -v`` register and shared-memory summary) is kept beside it with
the suffix ``.log``.  ``load`` opens it with ``ctypes`` once per process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build",
           "load", "launch_check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/*.cu at first use and need the CUDA toolkit")


def library_path(source: Path) -> Path:
    """Where ``build`` puts the library of ``source``: its name hashes the
    source, every ``csrc/*.cuh`` and the flags."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` into ``build/repro_torch/<stem>_<hash>.so``
    (skipped when a library for this exact source, headers and flags
    exists) and return its path.  The library and its ``.log`` are written
    under temporary names and renamed into place, the library last, so
    concurrent builders never load a half-written file."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                           str(source)],
                          capture_output=True, text=True)
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    tmp_log = tmp + ".log"
    Path(tmp_log).write_text(log + "\n")
    os.replace(tmp_log, out.with_suffix(".log"))
    os.replace(tmp, out)
    return out


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library built from ``source``, opened once per process;
    ``bind`` sets its functions' ``argtypes``/``restype`` on first open."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _libs[source] = lib
    return lib


def launch_check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
