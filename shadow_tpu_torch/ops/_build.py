"""Build and load the port's CUDA kernel.

``csrc/packet_hop.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/`` beside this
file (listed in .gitignore), and loaded with ``ctypes``.  The library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and a stale one is never loaded.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` or card there.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "packet_hop.cu")
BUILD_DIR = os.path.join(_HERE, "build")

# never --use_fast_math: the hop's uniform and its comparison against the
# f32 reliability must round exactly as the plain torch version does;
# -Xptxas -v puts the register and spill report in nvcc's output
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """$CUDA_HOME/bin/nvcc, else /usr/local/cuda/bin/nvcc, else the PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernel is built at first use")
    return found


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libpacket_hop-{digest.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the kernel's library.  Returns ``{"seconds", "log"}``
    (``log`` is nvcc's output, with ptxas's register and spill report).
    Raises RuntimeError with nvcc's output if the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = library_path()
    tmp = f"{lib}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return {"seconds": time.perf_counter() - t0, "log": log}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel's loaded library, building it first if needed."""
    path = library_path()
    if not os.path.exists(path):
        build()
    return ctypes.CDLL(path)
