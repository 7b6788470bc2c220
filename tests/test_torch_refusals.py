"""Paths the port has not ported refuse with NotImplementedError naming
their ROADMAP item, before any simulation work — they never quietly take
another path — the paths that were refused before their slice run and
equal the JAX package, and the port's CLI runs a config end to end on the
CPU."""

import io
import os
import shutil
import subprocess

import pytest

from shadow_tpu_torch import cli
from shadow_tpu_torch.apps import registry
from shadow_tpu_torch.core import configuration
from shadow_tpu_torch.core.controller import Controller, run_simulation
from shadow_tpu_torch.core.options import Options
from shadow_tpu_torch.tools.workloads import tor_network

ECHO = ('<shadow stoptime="5"><plugin id="e" path="python:echo" />'
        '<host id="h"><process plugin="e" starttime="1" '
        'arguments="udp server 8000" /></host></shadow>')
FLOW = ('<shadow stoptime="5"><host id="s" /><host id="c">'
        '<flow dest="s" down="1000" /></host></shadow>')
DEVICE_TOR = tor_network(2, n_clients=1, n_servers=1, device_data=True)
# three relays: a device-mode circuit needs three hops
DEVICE_TOR3 = tor_network(3, n_clients=2, n_servers=1, stoptime=60,
                          device_data=True)


@pytest.mark.parametrize("xml,opts,item", [
    (DEVICE_TOR, {"cost_model": "COSTMODEL.json"}, "A7"),
    (ECHO, {"cost_model": "COSTMODEL.json"}, "A7"),
])
def test_unported_paths_raise(xml, opts, item):
    cfg = configuration.parse_xml(xml)
    options = Options(device="cpu", stop_time_sec=5, **opts)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        run_simulation(options, cfg)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Controller(options, cfg)


@pytest.mark.parametrize("xml,opts", [
    (ECHO, {"scheduler_policy": "tpu", "tpu_devices": 2}),
    (ECHO, {"scheduler_policy": "tpu", "tpu_shard_matrix": True}),
    (DEVICE_TOR3, {"tpu_devices": 2}),
    (DEVICE_TOR3, {"scheduler_policy": "tpu", "tpu_devices": 2}),
    (DEVICE_TOR3, {"scheduler_policy": "tpu", "tpu_devices": 3,
                   "tpu_shard_matrix": True}),
])
def test_sharded_paths_run_and_equal_jax(xml, opts):
    """The sharded hop and the sharded traffic plane (once refused as
    ROADMAP B7 and A10) run on the CPU and end in the JAX package's state
    digest and event count."""
    import io

    from shadow_tpu.core import configuration as jconfiguration
    from shadow_tpu.core.checkpoint import state_digest as jdigest
    from shadow_tpu.core.controller import Controller as JController
    from shadow_tpu.core.logger import SimLogger as JSimLogger
    from shadow_tpu.core.logger import set_logger as jset_logger
    from shadow_tpu.core.options import Options as JOptions
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    set_logger(SimLogger(stream=io.StringIO(), level="warning"))
    stop = 60 if xml is DEVICE_TOR3 else 5
    ctrl = Controller(Options(device="cpu", stop_time_sec=stop, **opts),
                      configuration.parse_xml(xml))
    assert ctrl.run() == 0
    jset_logger(JSimLogger(stream=io.StringIO(), level="warning"))
    jctrl = JController(JOptions(stop_time_sec=stop, **opts),
                        jconfiguration.parse_xml(xml))
    assert jctrl.run() == 0
    assert (state_digest(ctrl.engine), ctrl.engine.events_executed) == \
        (jdigest(jctrl.engine), jctrl.engine.events_executed)
    if xml is DEVICE_TOR3:
        plane = ctrl.engine.device_plane
        assert plane._shard is not None
        assert plane.stats()["completed"] == 2


@pytest.mark.parametrize("xml,opts", [
    (ECHO, {"host_table": "on"}),
    (FLOW, {}),
])
def test_host_table_configs_run_and_equal_jax(xml, opts):
    """The HostTable tier is ported: --host-table=on and a processless
    flow (which boots the table by default and rides the device plane)
    run, with the JAX package's digest and event count."""
    import io

    from shadow_tpu.core import configuration as jconfiguration
    from shadow_tpu.core.checkpoint import state_digest as jdigest
    from shadow_tpu.core.controller import Controller as JController
    from shadow_tpu.core.logger import SimLogger as JSimLogger
    from shadow_tpu.core.logger import set_logger as jset_logger
    from shadow_tpu.core.options import Options as JOptions
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    set_logger(SimLogger(stream=io.StringIO(), level="warning"))
    ctrl = Controller(Options(device="cpu", stop_time_sec=5, **opts),
                      configuration.parse_xml(xml))
    assert ctrl.run() == 0
    assert ctrl.engine.host_table is not None
    jset_logger(JSimLogger(stream=io.StringIO(), level="warning"))
    jctrl = JController(JOptions(stop_time_sec=5, **opts),
                        jconfiguration.parse_xml(xml))
    assert jctrl.run() == 0
    assert (state_digest(ctrl.engine), ctrl.engine.events_executed) == \
        (jdigest(jctrl.engine), jctrl.engine.events_executed)


def _run_both(xml, stop=5, **opts):
    """The port's run_simulation and the JAX package's on one config:
    (rc, digest, events) of each.  A sharded run reports its coordinator's;
    a serial one its engine's."""
    from shadow_tpu.core import configuration as jconfiguration
    from shadow_tpu.core import controller as jcontroller
    from shadow_tpu.core.checkpoint import state_digest as jdigest
    from shadow_tpu.core.logger import SimLogger as JSimLogger
    from shadow_tpu.core.logger import set_logger as jset_logger
    from shadow_tpu.core.options import Options as JOptions
    from shadow_tpu.parallel.procs import ProcsController as JProcs
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.parallel.procs import ProcsController
    out = []
    for cfgmod, ctl, procs, digest, opt, setlog, logger, dev in (
            (configuration, Controller, ProcsController, state_digest,
             Options, set_logger, SimLogger, {"device": "cpu"}),
            (jconfiguration, jcontroller.Controller, JProcs, jdigest,
             JOptions, jset_logger, JSimLogger, {})):
        setlog(logger(stream=io.StringIO(), level="warning"))
        options = opt(stop_time_sec=stop, log_level="warning", **dev, **opts)
        if options.processes >= 2:
            run = procs(options, cfgmod.parse_xml(xml))
            out.append((run.run(), run.digest, run.events_executed))
        else:
            run = ctl(options, cfgmod.parse_xml(xml))
            rc = run.run()
            out.append((rc, digest(run.engine), run.engine.events_executed))
    return out


ECHO_PAIR = ('<shadow stoptime="5"><plugin id="e" path="python:echo" />'
             '<host id="s"><process plugin="e" starttime="1" '
             'arguments="udp server 8000" /></host><host id="c"><process '
             'plugin="e" starttime="2" arguments="udp client s 8000 3 100" />'
             '</host></shadow>')


@pytest.mark.parametrize("opts", [{"processes": 2},
                                  {"dataplane": "native"}],
                         ids=["A9-processes", "A14-native-dataplane"])
def test_lifted_paths_run_and_equal_jax(opts):
    """``--processes 2`` and ``--dataplane=native`` (once refused as
    ROADMAP A9 and A14) run through run_simulation and end in the JAX
    package's state digest and event count."""
    ours, theirs = _run_both(ECHO_PAIR, **opts)
    assert ours[0] == 0 and ours == theirs
    cfg = configuration.parse_xml(ECHO_PAIR)
    assert run_simulation(Options(device="cpu", stop_time_sec=5,
                                  log_level="warning", **opts), cfg) == 0


@pytest.fixture(scope="module")
def testapp_so(tmp_path_factory):
    """tests/native_src/testapp.c as a pooled plugin, linked against the
    port's shim (the pool's library path resolves each package's own)."""
    from shadow_tpu_torch.utils.native_build import ensure_plugins
    if not all(shutil.which(t) for t in ("cc", "g++", "make")):
        pytest.skip("needs cc, g++ and make")
    lib_dir = ensure_plugins()
    out = tmp_path_factory.mktemp("refusals") / "testapp.so"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "native_src", "testapp.c")
    subprocess.run(["cc", "-O1", "-fPIC", "-shared", "-o", str(out), src,
                    "-L", lib_dir, "-l:libshadow_preload.so", "-lpthread"],
                   check=True, capture_output=True)
    return str(out)


@pytest.mark.parametrize("path", ["exec:/bin/true", "pool:", "/bin/true"],
                         ids=["exec", "pool", "executable-path"])
def test_native_plugins_run_and_equal_jax(path, testapp_so):
    """The three native plugin forms (once refused as ROADMAP A15) resolve
    to the interposer, run a binary to exit 0, and end in the JAX
    package's digest and event count."""
    if path == "pool:":
        path, args = "pool:" + testapp_so, "hostname h"
    else:
        args = ""
    assert callable(registry.resolve(path))
    xml = (f'<shadow stoptime="10"><plugin id="p" path="{path}" />'
           f'<host id="h"><process plugin="p" starttime="1" '
           f'arguments="{args}" /></host></shadow>')
    ours, theirs = _run_both(xml, stop=10)
    assert ours[0] == 0 and ours == theirs
    assert registry.resolve("python:echo") is registry.resolve("echo")


def test_cli_runs_a_config_under_tpu_on_cpu(tmp_path):
    conf = tmp_path / "echo.xml"
    conf.write_text(tor_network(3, n_clients=2, n_servers=1, stoptime=8))
    rc = cli.main([str(conf), "--scheduler-policy=tpu", "--device", "cpu",
                   "--data-directory", str(tmp_path / "data"),
                   "--log-level", "warning"])
    assert rc == 0


def test_device_threshold_refused_on_cuda():
    """The numpy small-batch bypass would move hops to the host while the
    matrices are on the card: refused there, before any device work."""
    cfg = configuration.parse_xml(ECHO)
    options = Options(device="cuda", stop_time_sec=5,
                      scheduler_policy="tpu", tpu_device_threshold=64)
    with pytest.raises(NotImplementedError, match="--device cpu"):
        Controller(options, cfg)
