"""The port's C data plane (parallel/native_plane.py over its own build of
``native/dataplane.cc``) against the JAX package's, on the CPU.

The same config and seed run through the port's Python plane, the port's
C plane and the JAX package's C plane: the three end in one state digest
and one event count (the JAX package's tests hold its two planes to each
other).  The cases are those of the JAX package's
tests/test_native_dataplane.py (TCP echo lossless and lossy, Tor multihop,
star bulk, UDP PHOLD, each congestion control) and tests/test_native_round
.py (the C round executor against the per-event path, its demotion drill,
checkpoint and resume across it, an app's exception), plus the
eligibility rules (``auto`` attaches the plane wherever ``eligible``
allows, falls back with the reason logged elsewhere; ``native`` raises),
the wrapper's errors, and the two packages' extensions side by side in
one process.
"""

import io
import os
import sys

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
from shadow_tpu_torch.parallel import native_plane
from shadow_tpu_torch.tools import workloads

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_tcp_e2e import two_host_xml  # noqa: E402

TOR_KW = dict(n_relays=40, n_clients=25, n_servers=3, stoptime=30,
              stream_spec="512:20480")
PHOLD = ('<shadow stoptime="20"><plugin id="phold" path="python:phold" />'
         '<host id="phold" quantity="16" bandwidthdown="10240" '
         'bandwidthup="10240"><process plugin="phold" starttime="1" '
         'arguments="16 4 9000" /></host></shadow>')


def _port(xml, plane, stop, seed=42, policy="global", workers=0,
          setup_only=False, **kw):
    set_logger(SimLogger(stream=io.StringIO(), level="warning"))
    cfg = configuration.parse_xml(xml)
    cfg.stop_time_sec = stop
    ctrl = Controller(Options(device="cpu", scheduler_policy=policy,
                              workers=workers, stop_time_sec=stop,
                              seed=seed, dataplane=plane,
                              log_level="warning", **kw), cfg)
    if setup_only:
        ctrl.setup()
        return ctrl.engine
    assert ctrl.run() == 0
    return ctrl.engine


def _jax(xml, plane, stop, seed=42, policy="global", workers=0, **kw):
    jset_logger(JSimLogger(stream=io.StringIO(), level="warning"))
    cfg = jconfiguration.parse_xml(xml)
    cfg.stop_time_sec = stop
    ctrl = JController(JOptions(scheduler_policy=policy, workers=workers,
                                stop_time_sec=stop, seed=seed,
                                dataplane=plane, log_level="warning", **kw),
                       cfg)
    assert ctrl.run() == 0
    return ctrl.engine


def _key(eng, digest=state_digest):
    return digest(eng), eng.events_executed


PARITY = {
    "tcp-echo-lossless": (lambda: two_host_xml(
        "tcp client server 8000 5 2048"), 120, {}),
    "tcp-echo-lossy": (lambda: two_host_xml(
        "tcp client server 8000 5 2048", loss=0.1, stop=300), 300, {}),
    "tor-multihop": (lambda: workloads.tor_network(
        20, n_clients=10, n_servers=2, stoptime=60,
        stream_spec="512:20480"), 60, {}),
    "star-bulk": (lambda: workloads.star_bulk(
        10, stoptime=30, bulk_bytes=131072), 30, {}),
    "udp-phold": (lambda: PHOLD, 20, {}),
    **{f"cc-{cc}": (lambda: two_host_xml(
        "tcp client server 8000 4 8192", loss=0.05, stop=200), 200,
        {"tcp_congestion_control": cc}) for cc in ("reno", "aimd", "cubic")},
}


@pytest.mark.parametrize("name", list(PARITY))
def test_native_plane_equals_python_plane_and_jax(name):
    make, stop, kw = PARITY[name]
    xml = make()
    nat = _port(xml, "native", stop, **kw)
    assert nat.native_plane is not None, "the C plane did not engage"
    assert type(nat.scheduler.policy).__name__ == "NativeGlobalPolicy"
    py = _port(xml, "python", stop, **kw)
    assert py.native_plane is None
    want = _key(_jax(xml, "native", stop, **kw), jdigest)
    assert _key(nat) == _key(py) == want


def test_lossy_echo_client_exits_zero_on_the_c_plane():
    eng = _port(two_host_xml("tcp client server 8000 5 2048", loss=0.1,
                             stop=300), "native", 300)
    p = eng.host_by_name("client").processes[0]
    assert p.exited and p.exit_code == 0


def test_auto_attaches_the_c_plane_as_the_reference_does():
    """``--dataplane=auto`` (the default) on a serial global run: the
    port's C plane, the digest of the JAX package's auto run."""
    xml = workloads.tor_network(12, n_clients=6, n_servers=1, stoptime=40)
    assert Options().dataplane == "auto"
    eng = _port(xml, "auto", 40)
    assert eng.native_plane is not None
    assert _key(eng) == _key(_jax(xml, "auto", 40), jdigest)


@pytest.mark.parametrize("policy,workers,host_table", [
    ("steal", 2, "auto"), ("tpu", 0, "auto"), ("global", 0, "on")],
    ids=["threaded", "tpu", "lazy-table-rows"])
def test_eligibility_fallbacks(policy, workers, host_table):
    """Outside ``eligible`` (threads, another policy, lazy HostTable rows)
    ``auto`` runs the Python plane, as the reference does, with the JAX
    run's digest; ``native`` raises instead of degrading."""
    xml = two_host_xml("tcp client server 8000 2 1024")
    kw = dict(policy=policy, workers=workers, host_table=host_table)
    eng = _port(xml, "auto", 60, **kw)
    assert eng.native_plane is None
    assert _key(eng) == _key(_jax(xml, "auto", 60, **kw), jdigest)
    with pytest.raises(RuntimeError, match="dataplane=native"):
        _port(xml, "native", 60, **kw)


def test_native_wrapper_errors():
    """API error surface: ENOTCONN before connect, EADDRINUSE on a double
    bind."""
    eng = _port(two_host_xml("tcp client server 8000 2 1024"), "native", 30,
                setup_only=True)
    plane = eng.native_plane
    assert plane is not None
    host = eng.host_by_name("client")
    sock = plane.create_socket(host, "tcp")
    with pytest.raises(OSError, match="ENOTCONN"):
        sock.send_user_data(b"x")
    a = plane.create_socket(host, "tcp")
    b = plane.create_socket(host, "tcp")
    a.bind_native(host.ip, 5555, False)
    with pytest.raises(OSError, match="EADDRINUSE"):
        b.bind_native(host.ip, 5555, False)


def test_the_two_extensions_live_side_by_side():
    """Each package loads its own extension from its own directory under
    the spec name ``_shadow_dataplane`` (the extension's init symbol fixes
    it) and keeps its own module object."""
    from shadow_tpu.parallel import native_plane as jnative_plane
    from shadow_tpu_torch.utils import native_build
    ours, theirs = native_plane._load_module(), jnative_plane._load_module()
    assert ours is not None and theirs is not None and ours is not theirs
    assert ours.__name__ == theirs.__name__ == "_shadow_dataplane"
    assert os.path.dirname(ours.__file__) == native_build.NATIVE_DIR
    assert os.path.dirname(theirs.__file__).endswith(
        os.path.join("shadow_tpu", "native"))
    assert native_plane._MOD is ours and jnative_plane._MOD is theirs


# -- the C round executor (the JAX package's tests/test_native_round.py) ----

def _tor(**kw):
    xml = workloads.tor_network(**TOR_KW)
    return _port(xml, "auto", 30, seed=3, **kw), xml


def _demoted_run():
    """The per-event pop loop the executor replaced (the demotion
    target), on the port."""
    eng = _port(workloads.tor_network(**TOR_KW), "auto", 30, seed=3,
                setup_only=True)
    eng.scheduler.policy.round_demoted = True
    assert eng.run() == 0
    return eng


@pytest.fixture(scope="module")
def tor_runs():
    ex, xml = _tor()
    return {"executor": ex,
            "jax": _key(_jax(xml, "auto", 30, seed=3), jdigest)}


def test_round_executor_equals_per_event_path_and_jax(tor_runs):
    ex = tor_runs["executor"]
    pol = ex.scheduler.policy
    assert pol.round_windows > 0, "round executor never engaged"
    pe = _demoted_run()
    assert pe.scheduler.policy.round_windows == 0
    assert _key(ex) == _key(pe) == tor_runs["jax"]
    scrape = ex.metrics.scrape()
    assert scrape["native.round_windows"] == pol.round_windows
    assert scrape["native.round_demoted"] == 0


def test_round_executor_demotion_drill(tor_runs):
    """--fault-inject native-round:5: the executor hands over to the
    per-event path for good, one demotion is counted, and the digest is
    the healthy run's."""
    drilled, _xml = _tor(fault_inject="native-round:5")
    sup = drilled.supervision
    assert sup.native_round_demotions == 1 and sup.recoveries == 1
    assert drilled.scheduler.policy.round_demoted
    assert drilled.scheduler.policy.round_windows == 4
    assert _key(drilled) == tor_runs["jax"]


def test_round_executor_checkpoint_and_resume(tor_runs, tmp_path):
    ckdir = str(tmp_path / "ck")
    full, _xml = _tor(checkpoint_every_rounds=40, checkpoint_dir=ckdir)
    assert sorted(os.listdir(ckdir)), "no snapshot written"
    resumed, _xml = _tor(resume_path=ckdir)
    assert resumed.supervision.resume_verified
    assert resumed.scheduler.policy.round_windows > 0
    assert _key(resumed) == _key(full) == tor_runs["jax"]


def test_app_exception_propagates_not_demotes():
    """A simulated app's crash inside a window surfaces as on the
    per-event path, never as an executor failure."""
    from shadow_tpu_torch.core.task import Task
    from shadow_tpu_torch.core.worker import Worker, set_current_worker
    xml = ('<shadow stoptime="10"><plugin id="echo" path="python:echo" />'
           '<host id="u1"><process plugin="echo" starttime="1" '
           'arguments="udp server 9000" /></host><host id="u2"><process '
           'plugin="echo" starttime="2" arguments="udp client u1 9000 3 100"'
           ' /></host></shadow>')
    eng = _port(xml, "auto", 10, seed=3, setup_only=True)
    assert eng.native_plane is not None

    def _exploding(_obj, _arg):
        raise RuntimeError("app boom")

    w = Worker(0, eng)
    set_current_worker(w)
    try:
        host = next(iter(eng.hosts.values()))
        w.set_active_host(host)
        w.schedule_task(Task(_exploding, None, None, name="boom"),
                        2_000_000_000, dst_host=host)
        w.set_active_host(None)
    finally:
        set_current_worker(None)
    with pytest.raises(RuntimeError, match="app boom"):
        eng.run()
    assert eng.supervision.native_round_demotions == 0
    assert not eng.scheduler.policy.round_demoted


def test_an_engine_run_on_the_c_plane_is_freed():
    """The extension's Plane holds its callbacks and is invisible to the
    garbage collector; ``attach`` registers them through a weak reference,
    so an engine that ran on the C plane is freed once nothing refers to
    it.  The metrics registry keeps the latest engine until the next run
    registers, hence the second run."""
    import gc
    import weakref
    xml = PARITY["tcp-echo-lossless"][0]()
    first = _port(xml, "native", 120)
    assert first.native_plane is not None
    first = weakref.ref(first)
    assert _port(xml, "native", 120).native_plane is not None
    gc.collect()
    assert first() is None
