"""The port's native build step (utils/native_build.py) and the retransmit
tally it gives TCP.

The port builds its own native artifacts from ``native/`` into
``shadow_tpu_torch/native/``; the JAX package's tracked binaries in
``shadow_tpu/native/`` stay byte for byte as they were.  With the library
built, ``make_tally()`` of the port returns the C tally, which does what
the Python tally does on the same operations (random sequences here, the
JAX package's own ``OPS`` list too), and which the JAX package's
``NativeTally`` agrees with.
"""

import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from shadow_tpu.descriptor import retransmit_tally as jtally
from shadow_tpu_torch.descriptor import retransmit_tally as tally
from shadow_tpu_torch.utils import native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(REPO, "shadow_tpu", "native")
HAS_CXX = shutil.which("g++") is not None and shutil.which("make") is not None

# the JAX package's tests/test_tcp_e2e.py sequence
OPS = [("mark_sacked", 100, 200), ("mark_sacked", 300, 400),
       ("mark_retransmitted", 0, 50), ("update_lost", 0, 500, 3),
       ("mark_sacked", 450, 500), ("update_lost", 0, 500, 4),
       ("advance_una", 250)]


def _random_ops(seed: int, n: int = 400):
    """A TCP-like operation stream: ranges above a rising una."""
    rng = np.random.default_rng(seed)
    una, ops = 0, []
    for _ in range(n):
        kind = rng.integers(0, 6)
        b = una + int(rng.integers(0, 5000))
        e = b + int(rng.integers(1, 1500))
        if kind == 0:
            ops.append(("mark_sacked", b, e))
        elif kind == 1:
            ops.append(("mark_retransmitted", b, e))
        elif kind == 2:
            ops.append(("mark_lost", b, e))
        elif kind == 3:
            ops.append(("update_lost", una, una + 6000,
                        int(rng.integers(0, 6))))
        elif kind == 4:
            una += int(rng.integers(0, 800))
            ops.append(("advance_una", una))
        else:
            ops.append(("clear_lost",))
    return ops


def _observe(t, ops):
    """Apply ``ops`` to ``t``; what it reports after each one."""
    seen = []
    for op, *args in ops:
        getattr(t, op)(*args)
        seen.append((tuple(t.lost_ranges()), t.total_sacked(),
                     t.total_lost(), t.highest_sacked(),
                     t.is_sacked(args[0], args[0] + 10) if args else None))
    t.close()
    return seen


def _tree_digest(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _run(code: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def native_lib():
    if not HAS_CXX:
        pytest.skip("no g++ or make: the tally cannot be built")
    native_build.ensure("libshadow_tally.so")
    lib = tally._load_native()
    assert lib is not None, "the port's tally did not load"
    return lib


@pytest.mark.parametrize("ops", [OPS] + [_random_ops(s) for s in range(4)],
                         ids=["jax-ops"] + [f"random{s}" for s in range(4)])
def test_native_tally_equals_python_and_jax(native_lib, ops):
    ours = _observe(tally.NativeTally(native_lib), ops)
    assert ours == _observe(tally.PyTally(), ops)
    assert ours == _observe(jtally.make_tally(), ops)


def test_make_tally_returns_the_native_tally():
    """In a fresh process, as a run sees it: the Controller builds the
    library before the first socket, and make_tally() then answers with
    the C tally (it remembers its first answer)."""
    if not HAS_CXX:
        pytest.skip("no g++ or make: the tally cannot be built")
    res = _run(
        "from shadow_tpu_torch.core import configuration\n"
        "from shadow_tpu_torch.core.controller import Controller\n"
        "from shadow_tpu_torch.core.options import Options\n"
        "cfg = configuration.parse_xml('<shadow stoptime=\"2\"><plugin "
        "id=\"e\" path=\"python:echo\" /><host id=\"h\"><process "
        "plugin=\"e\" starttime=\"1\" arguments=\"udp server 8000\" />"
        "</host></shadow>')\n"
        "Controller(Options(device='cpu', stop_time_sec=2), cfg)\n"
        "from shadow_tpu_torch.descriptor.retransmit_tally import "
        "make_tally\n"
        "import shadow_tpu_torch.descriptor.retransmit_tally as rt\n"
        "print(type(make_tally()).__name__, rt._LIB._name)\n")
    assert res.returncode == 0, res.stderr
    name, path = res.stdout.split()
    assert name == "NativeTally"
    assert os.path.realpath(path) == os.path.realpath(
        native_build.artifact_path("libshadow_tally.so"))


def test_build_leaves_the_jax_binaries_byte_identical(tmp_path, monkeypatch):
    """The port's build step, every artifact from scratch (into a fresh
    directory): it writes nothing under shadow_tpu/native/."""
    if not HAS_CXX:
        pytest.skip("no g++ or make")
    before = _tree_digest(JAX_NATIVE)
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path))
    built = [native_build.ensure(name) for name in (
        "_shadow_dataplane.so", "libshadow_tally.so",
        *native_build.PLUGIN_ARTIFACTS)]
    assert [os.path.dirname(p) for p in built] == [str(tmp_path)] * 4
    assert all(os.path.getsize(p) > 0 for p in built)
    assert sorted(n for n in os.listdir(tmp_path)
                  if not n.startswith(".")) == sorted(
        os.path.basename(p) for p in built)
    assert _tree_digest(JAX_NATIVE) == before


def test_build_rebuilds_a_stale_artifact(tmp_path, monkeypatch):
    if not HAS_CXX:
        pytest.skip("no g++ or make")
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path))
    path = native_build.ensure("libshadow_tally.so")
    assert native_build.is_current("libshadow_tally.so")
    src = os.path.join(native_build.SOURCE_DIR, "retransmit_tally.cc")
    old = os.path.getmtime(src) - 100
    os.utime(path, (old, old))
    assert not native_build.is_current("libshadow_tally.so")
    assert native_build.ensure("libshadow_tally.so") == path
    assert os.path.getmtime(path) > old + 50
    assert native_build.is_current("libshadow_tally.so")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No sources: the build raises with make's output; the tally keeps
    its Python twin (logged), a native plugin refuses to run, and
    --dataplane=native raises instead of running the Python plane."""
    from shadow_tpu_torch.apps import registry
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.parallel import native_plane
    empty = tmp_path / "src"
    empty.mkdir()
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native_build, "SOURCE_DIR", str(empty))
    with pytest.raises(native_build.NativeBuildError, match="make"):
        native_build.ensure("libshadow_tally.so")
    assert native_build.ensure_tally() is False
    with pytest.raises(native_build.NativeBuildError):
        registry.resolve("exec:/bin/true")
    monkeypatch.setattr(native_plane, "_MOD", None)
    monkeypatch.setattr(native_plane, "_MOD_TRIED", False)
    cfg = configuration.parse_xml(
        '<shadow stoptime="5"><plugin id="e" path="python:echo" />'
        '<host id="h"><process plugin="e" starttime="1" '
        'arguments="udp server 8000" /></host></shadow>')
    with pytest.raises(RuntimeError, match="dataplane=native unavailable"):
        Controller(Options(device="cpu", stop_time_sec=5,
                           dataplane="native"), cfg).setup()
    assert not native_plane.native_available()


def test_unknown_artifact_refused():
    with pytest.raises(ValueError, match="unknown native artifact"):
        native_build.ensure("shadow_hotloop")
