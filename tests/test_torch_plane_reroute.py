"""A client whose fetched consensus lacks a relay takes its own path, and
the device plane's chains follow it.

The plane predicts each ``auto:`` client's path at startup from every
relay that will publish.  A relay whose descriptor reaches the authority
after a client fetched (here one that publishes at 55 s, after every
client has started) is missing from that client's consensus, so the
client draws another path than the prediction.  The plane then lays its
table out again at the next dispatch, while other clients' cells are in
flight; on this graph one re-route also lengthens the arrival ring.
The run must equal one in which that relay never publishes,
where the prediction is right from the start: the same paths, the same
entry and completion step for every chain, the same table and the same
per-flow results.
"""

import numpy as np
import pytest

STOP = 60
LATE = "relay3"


def _run(late_publishes: bool, mode: str, vertices: int = 12,
         seed: int = 7, device: str = "cpu"):
    from shadow_tpu_torch.core.configuration import parse_xml
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
    from shadow_tpu_torch.tools.workloads import tor_network
    cfg = parse_xml(tor_network(8, n_clients=12, n_servers=2, stoptime=STOP,
                                stream_spec="512:200000", seed=seed,
                                dirauth=True, device_data=True))
    cfg.topology_text = lossy_complete_graphml(vertices, seed)
    for h in cfg.hosts:
        if h.id.startswith("relay"):
            # 200 KiB/s relays: each download lasts seconds, its cells
            # in flight between relays, so other clients' cells are on
            # the wire when a chain is re-routed
            h.bandwidth_down_kibps = h.bandwidth_up_kibps = 200
    host = next(h for h in cfg.hosts if h.id == LATE)
    proc = host.processes[0]
    proc.start_time_sec = 55.0
    if not late_publishes:
        # a relay of no authority: not in the plane's prediction
        proc.arguments = " ".join(proc.arguments.split()[:2])
    # no packet dropped, so that nothing but the late relay differs
    opts = Options(scheduler_policy="tpu", device=device, workers=0, seed=9,
                   tpu_devices=1, device_plane=mode,
                   heartbeat_interval_sec=0, stop_time_sec=STOP,
                   bootstrap_end_sec=STOP, log_level="warning")
    ctl = Controller(opts, cfg)
    assert ctl.run() == 0
    return ctl


def _clients(ctl):
    out = {}
    for h in ctl.engine.hosts.values():
        if h.name.startswith("torclient"):
            p = h.processes[0]
            out[h.name] = (p.exit_code, list(p.app_state.path),
                           p.app_state.streams_ok,
                           p.app_state.consensus_relays)
    return out


def _same_as_never(late, never):
    a, b = late.engine.device_plane, never.engine.device_plane
    assert b.reroutes == 0 and a.reroutes >= 3
    ca, cb = _clients(late), _clients(never)
    assert ca == cb
    assert all(v[0] == 0 and v[2] == 3 and v[3] == 7 for v in ca.values())
    assert all(LATE not in v[1] for v in ca.values())
    inj_a, done_a = a.chain_steps()
    inj_b, done_b = b.chain_steps()
    assert (inj_a == inj_b).all() and (done_a == done_b).all()
    assert (done_a >= 0).all()
    assert a.granule == b.granule and a.ring_len == b.ring_len
    for k in ("flow_node", "flow_lat_steps", "flow_succ", "seg_start",
              "refill_step", "capacity_step", "first_flow", "last_flow"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for x, y in zip(a._read_summaries(), b._read_summaries()):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("mode", ["device", "numpy"])
def test_late_relay_reroutes_and_equals_the_run_without_it(mode):
    _same_as_never(_run(True, mode), _run(False, mode))


@pytest.mark.cuda
def test_late_relay_reroutes_on_the_card():
    """The same on the card: the state carried over through device
    tensors."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the port's kernels)")
    _same_as_never(_run(True, "device", device="cuda"),
                   _run(False, "device", device="cuda"))


def test_a_chain_that_has_entered_cannot_be_rerouted():
    ctl = _run(True, "device")
    plane = ctl.engine.device_plane
    spec = plane.specs[0]
    hops = list(reversed(spec.route_up[1:-1]))
    with pytest.raises(RuntimeError, match="cannot lay out"):
        plane.check_route(spec.client_name, hops)
