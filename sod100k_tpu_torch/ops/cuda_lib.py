"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` (a CUDA kernel) is compiled with nvcc for
``sm_90a``, each ``csrc/<name>.cc`` (host C++) with the host compiler, into
a shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, into ``sod100k_tpu_torch/_build/``, keyed by a
hash of the source, the compiler and the flags, so a fresh checkout builds
what it runs and a rebuilt source never loads a stale library. Nothing is
built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_CXX = os.environ.get("CXX", "c++")
HOST_FLAGS = ("-O3", "-std=c++17", "-pthread", "-fPIC", "-shared")


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _compile(src: str, name: str, compiler: str, flags) -> str:
    """Compile ``src`` with ``compiler`` and ``flags`` unless its library
    exists; returns the library path, keyed by a hash of the source, the
    compiler and the flags. The compiler's report is kept beside it as
    ``<lib>.log``."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join([compiler, *flags])
                                .encode())
    out = os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, src],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"{compiler} not found for "
                           f"{os.path.basename(src)}: {e}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed for {os.path.basename(src)}:\n"
                           f"{proc.stderr}")
    with open(f"{out}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` with nvcc (the report of ``-Xptxas -v``:
    registers, shared memory, spills, in ``<lib>.log``); returns the
    library path."""
    return _compile(os.path.join(CSRC_DIR, f"{name}.cu"), name,
                    find_nvcc(), NVCC_FLAGS)


def build_host(name: str) -> str:
    """Compile the host C++ ``csrc/<name>.cc`` with ``HOST_CXX`` (``$CXX``,
    else ``c++``); returns the library path. Raises ``RuntimeError`` with
    the compiler's stderr when the build fails or there is no compiler."""
    return _compile(os.path.join(CSRC_DIR, f"{name}.cc"), name, HOST_CXX,
                    HOST_FLAGS)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return ctypes.CDLL(build(name))


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cc``; cached per process."""
    return ctypes.CDLL(build_host(name))
