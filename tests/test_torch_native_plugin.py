"""Native plugins in the port (process/native.py, a verbatim copy of the
LD_PRELOAD interposer, over the port's own build of the shim and the pool
helper) against the JAX package, on the CPU.

Real, unmodified binaries (tests/native_src/testapp.c and testapp_cpp.cc,
compiled here into a temporary directory) run under the port and under
the JAX package with the same config and seed: every process exits 0 and
the two runs end in one state digest and one event count.  The cases are
about a dozen of the JAX package's tests/test_native_plugin.py: the
virtual clock, UDP and TCP, epoll/poll/select, DNS, seeded randomness, a
native client against a Python server, green threads, connected UDP,
edge-triggered epoll and a C++ binary; the ``tpu`` policy (global and tpu
equal, and equal to JAX); pooled ``.so`` plugins; and a spinning plugin
that the stall watchdog kills.  The fixtures here build through the port
(utils/native_build.py), never into ``shadow_tpu/native/``.
"""

import io
import os
import shutil
import subprocess
import time

import pytest

from shadow_tpu.core import configuration as jconfiguration
from shadow_tpu.core.checkpoint import state_digest as jdigest
from shadow_tpu.core.controller import Controller as JController
from shadow_tpu.core.logger import SimLogger as JSimLogger
from shadow_tpu.core.logger import set_logger as jset_logger
from shadow_tpu.core.options import Options as JOptions
from shadow_tpu_torch.core import configuration
from shadow_tpu_torch.core.checkpoint import state_digest
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.core.logger import SimLogger, set_logger
from shadow_tpu_torch.core.options import Options
from shadow_tpu_torch.utils import native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "tests", "native_src")

pytestmark = pytest.mark.skipif(
    not all(shutil.which(t) for t in ("cc", "g++", "make")),
    reason="needs cc, g++ and make to build the plugins and the shim")


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    """testapp as an executable and as a pooled ``.so`` (linked against
    the port's shim, resolved at run time through the pool's library
    path), and the C++ test binary; the port's shim and pool built first."""
    lib_dir = native_build.ensure_plugins()
    out = tmp_path_factory.mktemp("torch_native")
    app, so, cpp = out / "testapp", out / "testapp.so", out / "cppapp"
    for cmd in (
            ["cc", "-O1", "-o", str(app), os.path.join(SRC, "testapp.c"),
             "-lpthread"],
            ["cc", "-O1", "-fPIC", "-shared", "-o", str(so),
             os.path.join(SRC, "testapp.c"), "-L", lib_dir,
             "-l:libshadow_preload.so", "-lpthread"],
            ["g++", "-O1", "-std=c++17", "-o", str(cpp),
             os.path.join(SRC, "testapp_cpp.cc"), "-lpthread"]):
        subprocess.run(cmd, check=True, capture_output=True)
    return {"app": str(app), "so": str(so), "cpp": str(cpp)}


def _port(xml, stop, policy="global"):
    set_logger(SimLogger(stream=io.StringIO(), level="warning"))
    cfg = configuration.parse_xml(xml)
    cfg.stop_time_sec = stop
    ctrl = Controller(Options(device="cpu", scheduler_policy=policy,
                              workers=0, stop_time_sec=stop,
                              log_level="warning"), cfg)
    rc = ctrl.run()
    return rc, ctrl.engine


def _jax(xml, stop, policy="global"):
    jset_logger(JSimLogger(stream=io.StringIO(), level="warning"))
    cfg = jconfiguration.parse_xml(xml)
    cfg.stop_time_sec = stop
    ctrl = JController(JOptions(scheduler_policy=policy, workers=0,
                                stop_time_sec=stop, log_level="warning"),
                       cfg)
    rc = ctrl.run()
    return rc, ctrl.engine


def _codes(eng):
    return {h.name: [p.exit_code for p in h.processes]
            for h in eng.hosts.values()}


def _hosts(*specs):
    """<host> elements: (name, plugin, starttime, arguments) each."""
    return "".join(f'<host id="{h}" bandwidthdown="10240" '
                   f'bandwidthup="10240"><process plugin="{p}" '
                   f'starttime="{t}" arguments="{a}" /></host>'
                   for h, p, t, a in specs)


# name -> (stop, hosts); plugins: "app" (testapp), "cpp" (the C++ binary),
# "echo" (the Python echo app)
SCENARIOS = {
    "vtime": (30, [("node", "app", 1, "vtime")]),
    "udp-echo": (60, [("server", "app", 1, "udpserver 8000 5"),
                      ("client", "app", 2, "udpclient server 8000 5 512")]),
    "tcp-transfer": (120, [("server", "app", 1, "tcpserver 8001 200000"),
                           ("client", "app", 2,
                            "tcpclient server 8001 200000")]),
    "epoll-poll-select": (90, [("server", "app", 1, "epollserver 8002 3"),
                               ("c1", "app", 2, "pollclient server 8002"),
                               ("c2", "app", 3, "pollclient server 8002"),
                               ("c3", "app", 4, "selectclient server 8002")]),
    "hostname-dns": (30, [("mynode", "app", 1, "hostname mynode")]),
    "randcheck": (30, [("node", "app", 1, "randcheck")]),
    "native-client-python-server": (
        60, [("server", "echo", 1, "udp server 8000"),
             ("client", "app", 2, "udpclient server 8000 4 256")]),
    "pthreads": (30, [("node", "app", 1, "threads")]),
    "connected-udp": (60, [("server", "app", 1, "udpserver 8000 3"),
                           ("client", "app", 2,
                            "udpconnclient server 8000 3 200")]),
    "edge-triggered-epoll": (90, [("server", "app", 1, "etserver 8002 2"),
                                  ("c1", "app", 2, "pollclient server 8002"),
                                  ("c2", "app", 3,
                                   "pollclient server 8002")]),
    "cpp-binary": (30, [("server", "app", 1, "udpserver 8000 1"),
                        ("client", "cpp", 2, "udp server 8000")]),
}


def _xml(bins, stop, hosts, app_path=None):
    return (f'<shadow stoptime="{stop}">'
            f'<plugin id="app" path="{app_path or bins["app"]}" />'
            f'<plugin id="cpp" path="{bins["cpp"]}" />'
            '<plugin id="echo" path="python:echo" />'
            + _hosts(*hosts) + "</shadow>")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_native_plugin_runs_and_equals_jax(bins, name):
    stop, hosts = SCENARIOS[name]
    xml = _xml(bins, stop, hosts)
    rc, eng = _port(xml, stop)
    assert rc == 0
    # every binary exits 0 (the Python echo server serves to the end)
    want = {h[0]: [0] for h in hosts if h[1] != "echo"}
    assert {k: v for k, v in _codes(eng).items() if k in want} == want
    jrc, jeng = _jax(xml, stop)
    assert jrc == 0
    assert (state_digest(eng), eng.events_executed) == \
        (jdigest(jeng), jeng.events_executed)
    if name == "randcheck":
        def out(e):
            return (e.host_by_name("node").processes[0].app_state
                    or {}).get("stdout", b"")
        assert out(eng).startswith(b"randcheck ") and out(eng) == out(jeng)


@pytest.mark.parametrize("name", ["tcp-transfer", "udp-echo"],
                         ids=["under-tpu-policy",
                              "digest-parity-across-policies"])
def test_native_plugins_under_tpu_policy(bins, name):
    """A real-binary workload under ``tpu`` (the hops through the port's
    hop wrapper) ends in the ``global`` run's digest, and both in the JAX
    package's."""
    stop, hosts = SCENARIOS[name]
    xml = _xml(bins, stop, hosts)
    keys = {}
    for policy in ("global", "tpu"):
        rc, eng = _port(xml, stop, policy)
        assert rc == 0 and _codes(eng) == {h[0]: [0] for h in hosts}, policy
        keys[policy] = (state_digest(eng), eng.events_executed)
        if policy == "tpu":
            assert eng.scheduler.policy._kernel.device_calls > 0
    rc, jeng = _jax(xml, stop)
    assert rc == 0
    assert keys["global"] == keys["tpu"] == \
        (jdigest(jeng), jeng.events_executed)


def test_pooled_workload_digest_parity(bins):
    """Six UDP pairs as pooled ``.so`` instances (dlmopen namespaces in
    shared helper processes): global and tpu end in one digest, the JAX
    package's."""
    hosts = []
    for i in range(6):
        hosts += [(f"s{i}", "app", 1, f"udpserver {8100 + i} 2"),
                  (f"c{i}", "app", 2, f"udpclient s{i} {8100 + i} 2 300")]
    xml = _xml(bins, 30, hosts, app_path="pool:" + bins["so"])
    keys = {}
    for policy in ("global", "tpu"):
        rc, eng = _port(xml, 30, policy)
        assert rc == 0, policy
        pools = getattr(eng, "_native_pools", [])
        assert pools and sum(p.count for p in pools) == 12
        keys[policy] = (state_digest(eng), eng.events_executed)
    rc, jeng = _jax(xml, 30)
    assert rc == 0
    assert keys["global"] == keys["tpu"] == \
        (jdigest(jeng), jeng.events_executed)


def test_spinning_plugin_killed_not_frozen(bins, monkeypatch):
    """A plugin that spins without syscalls does not freeze the virtual
    clock: the stall watchdog kills it and the run completes."""
    from shadow_tpu_torch.process import native as native_mod
    monkeypatch.setattr(native_mod, "STALL_TIMEOUT_SEC", 2.0)
    xml = _xml(bins, 30, [("node", "app", 1, "spin")])
    t0 = time.monotonic()
    _rc, eng = _port(xml, 30)
    assert time.monotonic() - t0 < 60, "simulator froze on a spinning plugin"
    assert _codes(eng)["node"] != [0]


def test_the_plugins_use_the_ports_shim(bins):
    """The shim an exec: plugin is preloaded with is the port's build."""
    from shadow_tpu_torch.process import native as native_mod
    assert native_mod._PRELOAD_LIB == native_build.artifact_path(
        "libshadow_preload.so")
    assert native_mod._POOL_BIN == native_build.artifact_path("shadow_pool")
    assert os.path.isfile(native_mod._PRELOAD_LIB)
    assert os.access(native_mod._POOL_BIN, os.X_OK)
