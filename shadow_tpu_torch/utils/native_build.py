"""Build the port's native artifacts from the repository's ``native/``.

The C data plane (``_shadow_dataplane.so``), the retransmit tally
(``libshadow_tally.so``), the native plugins' LD_PRELOAD shim
(``libshadow_preload.so``) and their pool helper (``shadow_pool``) are built
from ``native/`` by ``native/Makefile``.  That Makefile writes into the JAX
package (``OUT := ../shadow_tpu/native``), whose binaries are tracked in
git; the port never loads, rebuilds or writes them.  It builds its own
copies into ``shadow_tpu_torch/native/`` (listed in .gitignore), where its
loaders look (``parallel/native_plane.py``, ``descriptor/retransmit_tally.py``
and ``process/native.py``):

    make -C native -s OUT=<tmp> PY_INCLUDES=-I<python include> <tmp>/<artifact>

into a temporary directory beside the artifact, then ``os.replace`` into
place, so that a loader never sees half a file.  ``OUT`` and
``PY_INCLUDES`` on the command line override the Makefile's, so the build
needs neither an edit there nor ``python3-config``.  An ``fcntl`` lock
around the build makes processes that arrive at once (pytest workers,
``--processes`` shards) build once.  An artifact is rebuilt when one of its
sources, or the Makefile, is newer than it.

Nothing builds at import.  :func:`ensure` raises :class:`NativeBuildError`
with make's output when a build fails; each caller decides what a missing
artifact means (``--dataplane=native`` and native plugins raise, the tally
falls back to its Python twin as its loader always did).
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import sysconfig
import tempfile
from contextlib import contextmanager
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
SOURCE_DIR = os.path.join(os.path.dirname(_PKG), "native")

_PRELOAD = ("preload/shim.cc", "preload/shim_threads.cc",
            "preload/shim_misc.cc", "preload/shim_files.cc",
            "preload/protocol.h", "preload/shim_threads.h")
# each artifact's sources in native/ (its Makefile rule's prerequisites)
ARTIFACTS: Dict[str, Tuple[str, ...]] = {
    "_shadow_dataplane.so": ("dataplane.cc",),
    "_shadow_dataplane_san.so": ("dataplane.cc",),
    "_shadow_dataplane_tsan.so": ("dataplane.cc",),
    "libshadow_tally.so": ("retransmit_tally.cc",),
    "libshadow_preload.so": _PRELOAD,
    "shadow_pool": ("pool/pool_main.cc",),
}
# what a native plugin needs: the shim for exec:, and the pool for pool:
PLUGIN_ARTIFACTS = ("libshadow_preload.so", "shadow_pool")
BUILD_TIMEOUT_SEC = 300


class NativeBuildError(RuntimeError):
    """A native artifact could not be built."""


def artifact_path(name: str) -> str:
    if name not in ARTIFACTS:
        raise ValueError(f"unknown native artifact {name!r} (choices: "
                         f"{', '.join(ARTIFACTS)})")
    return os.path.join(NATIVE_DIR, name)


def is_current(name: str) -> bool:
    """Whether the built artifact exists and no source is newer."""
    path = artifact_path(name)
    if not os.path.exists(path):
        return False
    built = os.path.getmtime(path)
    srcs = ARTIFACTS[name] + ("Makefile",)
    return all(os.path.getmtime(os.path.join(SOURCE_DIR, s)) <= built
               for s in srcs if os.path.exists(os.path.join(SOURCE_DIR, s)))


@contextmanager
def _locked():
    os.makedirs(NATIVE_DIR, exist_ok=True)
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _make(name: str, sanitize: str) -> None:
    include = sysconfig.get_paths()["include"]
    tmp = tempfile.mkdtemp(prefix=".build-", dir=NATIVE_DIR)
    try:
        args = ["make", "-C", SOURCE_DIR, "-s", f"OUT={tmp}",
                f"PY_INCLUDES=-I{include}"]
        if sanitize and name == "_shadow_dataplane_san.so":
            args.append(f"SANITIZE={sanitize}")
        args.append(os.path.join(tmp, name))
        try:
            res = subprocess.run(args, capture_output=True, text=True,
                                 timeout=BUILD_TIMEOUT_SEC)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"building {name}: {e}") from e
        if res.returncode != 0:
            raise NativeBuildError(
                f"building {name} from {SOURCE_DIR} failed (make exit "
                f"{res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(os.path.join(tmp, name), artifact_path(name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ensure(name: str, sanitize: str = "") -> str:
    """The path of the port's built ``name``, building it first if it is
    missing or older than a source.  ``sanitize`` is the -fsanitize= list
    of the ``_shadow_dataplane_san.so`` twin.  Raises NativeBuildError."""
    path = artifact_path(name)
    if is_current(name):
        return path
    with _locked():
        if not is_current(name):    # another process may have built it
            _make(name, sanitize)
    return path


def ensure_tally() -> bool:
    """Build the retransmit tally before the first TCP socket asks for it
    (``make_tally`` remembers its first answer).  False when it cannot be
    built: TCP then keeps the Python tally, as the JAX package's does
    without the library."""
    try:
        ensure("libshadow_tally.so")
    except NativeBuildError as e:
        from ..core.logger import get_logger
        get_logger().warning("native", f"retransmit tally not built, TCP "
                             f"uses the Python tally: {e}")
        return False
    return True


def ensure_plugins() -> str:
    """Build the preload shim and the pool helper; returns their
    directory.  Raises NativeBuildError: a native plugin never runs
    without them."""
    for name in PLUGIN_ARTIFACTS:
        ensure(name)
    return NATIVE_DIR
