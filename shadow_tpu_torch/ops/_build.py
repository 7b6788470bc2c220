"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/`` beside this
file (listed in .gitignore), and loaded with ``ctypes``.  A library's file
name carries a hash of its source, of the ``csrc/`` headers it includes
(``#include "x.cuh"``) and of the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  :func:`build` compiles several sources at
once, one ``nvcc`` process each, all started together.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` or card there.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time as _walltime
from typing import Dict, Iterable, List, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")
KERNELS = ("packet_hop", "torcells_span", "pack_flush",
           "torcells_span_batched", "saturate", "admit_sorted", "phold",
           "torcells_run", "mesh_span", "packet_hop_sharded")

# never --use_fast_math: the hop's uniform and its comparison against the
# f32 reliability must round exactly as the plain torch version does;
# -Xptxas -v puts the register and spill report in nvcc's output
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def source_path(name: str) -> str:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r} (choices: "
                         f"{', '.join(KERNELS)})")
    return os.path.join(_HERE, "csrc", f"{name}.cu")


def nvcc_path() -> str:
    """$CUDA_HOME/bin/nvcc, else /usr/local/cuda/bin/nvcc, else the PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels are built at first use")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: str, seen: List[str]) -> List[str]:
    """``path`` and, depth first, every header it includes by a quoted
    name from its own directory."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in _LOCAL_INCLUDE.findall(text):
        _sources(os.path.join(os.path.dirname(path), inc.decode()), seen)
    return seen


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(source_path(name), []):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the kernels' libraries (all of them by default), one nvcc
    process per source, all started together.  Returns ``{name:
    {"seconds", "log"}}`` (``log`` is nvcc's output, with ptxas's register
    and spill report).  Raises RuntimeError with nvcc's output if a build
    fails."""
    names = list(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        lib = library_path(name)
        tmp = f"{lib}.tmp{os.getpid()}"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp,
                                 source_path(name)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib, _walltime.perf_counter())
    out, failed = {}, []
    for name, (proc, tmp, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source_path(name)} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = {"seconds": _walltime.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, building it first if needed."""
    path = library_path(name)
    if not os.path.exists(path):
        build([name])
    return ctypes.CDLL(path)


def entry(name: str, symbol: str, argtypes):
    """A C entry point of the kernel library ``name`` (csrc/<name>.cu),
    built at first use, with its argument types bound (every entry returns
    an int: 0, or the CUDA error of a refused launch)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_tensor(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    """Raise ValueError unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``dev``: what a kernel takes, it takes exactly."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape} on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
