"""The port's C data plane under AddressSanitizer and UBSan (slow tier).

The port twin of tests/test_native_sanitize.py.  It builds the port's
instrumented twin ``shadow_tpu_torch/native/_shadow_dataplane_san.so``
through utils/native_build.py (``-fsanitize=address,undefined
-fno-omit-frame-pointer``, native/Makefile's ``SANITIZE=`` rule), then
replays the port's native-plane suite (tests/test_torch_native_plane.py)
in a subprocess whose ``SHADOW_SANITIZE`` makes
``parallel/native_plane._load_module`` load that twin, with the ASan
runtime preloaded (a stock interpreter lacks it).  The suite holds the
port's plane to the JAX package's, whose loader reads the same variable:
the subprocess loads the JAX package's extension first, uninstrumented,
and names the sanitizer after it, so only the port's plane runs
instrumented and nothing is built into ``shadow_tpu/native/``.  The
suite's ``tpu`` eligibility case runs the JAX package's jit, whose XLA
compiler aborts under a preloaded ASan runtime; the C plane is never
attached in that case, and the replay leaves it out.  Any sanitizer report
fails the test; a toolchain without the runtimes skips, saying why.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from shadow_tpu_torch.utils import native_build

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAN_SPEC = "address,undefined"
SUITE = os.path.join("tests", "test_torch_native_plane.py")
# the JAX package's extension loaded before the sanitizer is named, then
# argv[1] as SHADOW_SANITIZE for the port's loader, then argv[2] run as
# Python source
_PRELUDE = ("import os, sys\n"
            "from shadow_tpu.parallel import native_plane as jax_plane\n"
            "assert jax_plane.native_available()\n"
            "os.environ['SHADOW_SANITIZE'] = sys.argv[1]\n"
            "exec(sys.argv[2])\n")
PROBE = ("from shadow_tpu_torch.parallel import native_plane as n; "
         "sys.exit(0 if n.native_available() else 3)")


def run_instrumented(env: dict, spec: str, code: str, timeout: int):
    """``code`` in a subprocess under ``env``, the port's plane built
    with ``-fsanitize=spec`` and the JAX package's left as it is."""
    return subprocess.run([sys.executable, "-c", _PRELUDE, spec, code],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def replay_suite(env: dict, spec: str, deselect: str = ""):
    """The port's native-plane suite under the instrumented plane."""
    args = ["-q", "-p", "no:cacheprovider", "-p", "no:xdist", SUITE]
    if deselect:
        args += ["-k", f"not {deselect}"]
    return run_instrumented(
        env, spec, f"import pytest; sys.exit(pytest.main({args!r}))",
        timeout=3600)


def sanitizer_runtime_or_skip(tmp_path, spec: str, runtime: str) -> str:
    """Check that g++ compiles and links ``-fsanitize=spec`` here and
    return the runtime ``runtime`` (libasan.so, libtsan.so) to preload;
    skip, saying why, when a piece is missing."""
    gxx = os.environ.get("CXX") or "g++"
    if shutil.which(gxx) is None:
        pytest.skip(f"no C++ compiler ({gxx}): cannot build the "
                    "instrumented data plane")
    smoke = tmp_path / "smoke.cc"
    smoke.write_text('extern "C" int shd_smoke(int x) { return x + 1; }\n')
    try:
        probe = subprocess.run(
            [gxx, f"-fsanitize={spec}", "-fno-omit-frame-pointer",
             "-shared", "-fPIC", "-o", str(tmp_path / "smoke.so"),
             str(smoke)], capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        pytest.skip(f"sanitizer smoke compile failed to run: {e!r}")
    if probe.returncode != 0:
        pytest.skip(f"toolchain lacks the -fsanitize={spec} runtime:\n"
                    f"{probe.stderr}")
    path = subprocess.run([gxx, f"-print-file-name={runtime}"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip()
    if not os.path.isabs(path) or not os.path.exists(path):
        pytest.skip(f"{runtime} not found (g++ -print-file-name gave "
                    f"{path!r})")
    return path


def build_twin_or_skip(artifact: str, spec: str) -> None:
    """Build the instrumented twin through utils/native_build.py."""
    try:
        native_build.ensure(artifact, sanitize=spec)
    except native_build.NativeBuildError as e:
        pytest.skip(f"the instrumented data plane did not build:\n{e}")
    assert os.path.exists(native_build.artifact_path(artifact))


def probe_loads_or_skip(env: dict, spec: str) -> None:
    """The twin must load, or the suite would skip its native cases and
    pass without testing anything."""
    probe = run_instrumented(env, spec, PROBE, timeout=300)
    if probe.returncode == 3:
        pytest.skip("the instrumented extension built but did not load "
                    f"(runtime mismatch?):\n{probe.stderr[-2000:]}")
    assert probe.returncode == 0, (
        f"the probe died under the sanitizer (rc {probe.returncode}):\n"
        f"{probe.stderr[-3000:]}")


def test_native_plane_suite_under_asan_ubsan(tmp_path):
    libasan = sanitizer_runtime_or_skip(tmp_path, SAN_SPEC, "libasan.so")
    build_twin_or_skip("_shadow_dataplane_san.so", SAN_SPEC)
    env = dict(os.environ)
    env.pop("SHADOW_SANITIZE", None)
    env.update({
        "LD_PRELOAD": libasan,
        # CPython leaks its interned and static allocations at exit by
        # design, so leak reports would drown real ones; abort_on_error
        # turns any report into a nonzero exit
        "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
        "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
        "JAX_PLATFORMS": "cpu",
    })
    probe_loads_or_skip(env, SAN_SPEC)
    run = replay_suite(env, SAN_SPEC, deselect="tpu")
    text = run.stdout + run.stderr
    for marker in ("ERROR: AddressSanitizer", "ERROR: LeakSanitizer",
                   "runtime error:", "AddressSanitizer:DEADLYSIGNAL"):
        assert marker not in text, (
            f"sanitizer report under the port's native-plane suite "
            f"({marker}):\n{text[-4000:]}")
    assert run.returncode == 0, (
        f"the port's native-plane suite failed under ASan/UBSan (rc "
        f"{run.returncode}):\n{text[-4000:]}")
    assert " passed" in text
