"""The tpu policy's spans, its lanes counter and its hop record.

A tiny Tor network with processes (a directory authority, 8 relays, 4
clients on a 4-vertex lossy graph) runs under ``--scheduler-policy=tpu``
on the CPU.  With a tracer installed, ``hop.launch`` spans one a kernel
launch, each ``hop.wait`` lies inside a ``hop.consume``, and the lanes
counted equal the record's.  With the record off the run's state digest
is the same and no record is kept, and with no tracer enabled the policy
records no span.
"""

import pytest

from shadow_tpu_torch.obs import trace as obs_trace
from shadow_tpu_torch.obs.trace import Tracer


@pytest.fixture
def fresh():
    yield
    obs_trace.set_tracer(Tracer(enabled=False))


def _run(hop_record: bool):
    from shadow_tpu_torch.core.configuration import parse_xml
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
    from shadow_tpu_torch.tools.workloads import tor_network
    cfg = parse_xml(tor_network(8, n_clients=4, n_servers=1, stoptime=15,
                                stream_spec="512:20200", seed=4,
                                dirauth=True, device_data=True))
    cfg.topology_text = lossy_complete_graphml(4, 4)
    opts = Options(scheduler_policy="tpu", device="cpu", workers=0, seed=9,
                   tpu_devices=1, hop_record=hop_record,
                   heartbeat_interval_sec=0, stop_time_sec=15,
                   log_level="warning")
    ctl = Controller(opts, cfg)
    assert ctl.run() == 0
    return ctl


def test_spans_counter_and_record(fresh):
    tracer = obs_trace.install(Tracer(enabled=True))
    ctl = _run(True)
    pol = ctl.engine.scheduler.policy
    tot = tracer.totals()
    assert pol.kernel_calls > 0
    assert tot["hop.launch"][0] == pol.kernel_calls
    events = [e for e in tracer.events() if e["name"].startswith("hop.")]
    launched = sum(e["args"]["lanes"] for e in events
                   if e["name"] == "hop.launch")
    consumes = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                if e["name"] == "hop.consume"]
    waits = [e for e in events if e["name"] == "hop.wait"]
    assert waits and consumes
    for w in waits:
        assert any(tid == w["tid"] and a <= w["ts"]
                   and w["ts"] + w["dur"] <= b for a, b, tid in consumes)
    record = pol.hop_record
    assert len(record) == pol.kernel_calls
    assert sum(len(e.src) for e in record) == pol.lanes_hopped == launched
    assert pol.lanes_hopped == pol.packets_batched
    consumed = [e for e in record if e.deliver is not None]
    assert consumed and all(
        len(e.deliver) == len(e.keep) == len(e.src) == len(e.dst)
        == len(e.uid) == len(e.send) for e in consumed)


def test_record_off_same_digest_no_spans(monkeypatch):
    from shadow_tpu_torch.core.checkpoint import state_digest
    with_record = state_digest(_run(True).engine)
    spans = []
    complete = Tracer.complete
    monkeypatch.setattr(Tracer, "complete",
                        lambda self, name, *a, **k:
                        (spans.append(name), complete(self, name, *a,
                                                      **k))[1])
    ctl = _run(False)
    assert ctl.engine.scheduler.policy.hop_record is None
    assert state_digest(ctl.engine) == with_record
    assert not [n for n in spans if n.startswith("hop.")]
