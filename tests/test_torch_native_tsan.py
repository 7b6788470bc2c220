"""The port's C data plane under ThreadSanitizer (slow tier).

The port twin of tests/test_native_tsan.py.  It builds the port's
``shadow_tpu_torch/native/_shadow_dataplane_tsan.so`` through
utils/native_build.py (``-fsanitize=thread``, native/Makefile's TSan
rule), then replays the port's native-plane suite
(tests/test_torch_native_plane.py) in a subprocess with
``SHADOW_SANITIZE=thread`` and the TSan runtime preloaded (the JAX
package's extension loaded first, uninstrumented, as in
tests/test_torch_native_sanitize.py).  TSan
instruments the whole process, CPython included, whose internals can trip
reports of their own; so the run does not halt on a report, and the test
fails on reports whose stacks reach the data plane (``dataplane`` frames)
and counts the rest.  No BLAS thread pool: an import-time fork must happen
while the process has one thread (see tests/test_native_tsan.py).  A
toolchain without the runtime skips, saying why.
"""

from __future__ import annotations

import os
import re

import pytest

from test_torch_native_sanitize import (build_twin_or_skip,
                                        probe_loads_or_skip, replay_suite,
                                        sanitizer_runtime_or_skip)

pytestmark = pytest.mark.slow


def _dataplane_reports(text: str):
    """ThreadSanitizer report blocks whose stacks reach the data plane."""
    blocks = re.split(r"(?=WARNING: ThreadSanitizer:)", text)
    return [b for b in blocks
            if b.startswith("WARNING: ThreadSanitizer:")
            and "dataplane" in b]


def test_native_plane_suite_under_tsan(tmp_path):
    libtsan = sanitizer_runtime_or_skip(tmp_path, "thread", "libtsan.so")
    build_twin_or_skip("_shadow_dataplane_tsan.so", "thread")
    env = dict(os.environ)
    env.pop("SHADOW_SANITIZE", None)
    env.update({
        "LD_PRELOAD": libtsan,
        "TSAN_OPTIONS": "halt_on_error=0:exitcode=0:history_size=4",
        "JAX_PLATFORMS": "cpu",
        "OPENBLAS_NUM_THREADS": "1",
        "OMP_NUM_THREADS": "1",
    })
    probe_loads_or_skip(env, "thread")
    run = replay_suite(env, "thread")
    text = run.stdout + run.stderr
    ours = _dataplane_reports(text)
    assert not ours, (
        f"ThreadSanitizer reported {len(ours)} race(s) reaching the data "
        f"plane:\n{ours[0][:4000]}")
    total = text.count("WARNING: ThreadSanitizer:")
    if total:
        print(f"note: {total} TSan report(s) outside the data plane "
              "(CPython internals) were tolerated")
    assert run.returncode == 0, (
        f"the port's native-plane suite failed under TSan (rc "
        f"{run.returncode}):\n{text[-4000:]}")
    assert " passed" in text
