"""The bandwidth saturation model in the port, on the CPU, against the JAX
package.

The port's ``saturate_run`` (on CPU tensors: its plain torch version) must
equal, bit for bit on all four outputs, the JAX package's ``saturate_run``
and the numpy twin on the JAX test's inputs (64 hosts x 5,000 ticks, made
by numpy from a seed); the closed-form rates and the engine cross-check of
the JAX package's tests/test_saturate_device.py must hold for the port's
model and the port's own engine.  Tolerance: none (int64, exact).
"""

import textwrap

import numpy as np
import pytest
import torch

import shadow_tpu.ops.saturate_device as jsd
import shadow_tpu_torch.ops.saturate_device as tsd
from shadow_tpu_torch.core import defs

PAYLOAD = 958
SIZE = PAYLOAD + defs.CONFIG_HEADER_SIZE_UDPIPETH   # 1000 B on the wire
NAMES = ("delivered", "dropped", "queue", "tokens")


def test_plain_version_matches_jax_and_numpy_twin():
    rng = np.random.default_rng(11)
    h = 64
    bw = rng.integers(200, 2000, size=h)
    first = rng.integers(0, 50, size=h).astype(np.int64)
    n = rng.integers(100, 3000, size=h).astype(np.int64)
    ticks = 5000
    port = tsd.DeviceSaturate(bw, device="cpu")
    ref = jsd.DeviceSaturate(bw)
    got = port.run_device(first, n, ticks)
    for a, b, c, name in zip(got, ref.run_device(first, n, ticks),
                             ref.run_numpy(first, n, ticks), NAMES):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b, err_msg=f"port vs JAX: {name}")
        np.testing.assert_array_equal(a, c, err_msg=f"port vs twin: {name}")
    np.testing.assert_array_equal(
        np.stack(port.run_numpy(first, n, ticks)), np.stack(got))
    # the parameter range exercises both regimes
    assert (got[1] > 0).any() and (got[1] == 0).any()


def test_dispatch_on_cpu_tensors_is_the_plain_version():
    rng = np.random.default_rng(12)
    h = 16
    first = torch.as_tensor(rng.integers(0, 20, size=h))
    n = torch.as_tensor(rng.integers(50, 500, size=h))
    refill = torch.as_tensor(rng.integers(300, 1500, size=h))
    cap = refill * 2 + 1500
    before = tsd.saturate_run.launches
    a = tsd.saturate_run(first, n, SIZE, refill, cap, 64, 700)
    b = tsd.saturate_run_torch(first, n, SIZE, refill, cap, 64, 700)
    assert tsd.saturate_run.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_zero_ticks_returns_the_initial_state():
    cap = torch.tensor([5000, 7000])
    d, dr, q, tok = tsd.saturate_run(torch.zeros(2, dtype=torch.int64),
                                     torch.ones(2, dtype=torch.int64), SIZE,
                                     torch.tensor([10, 20]), cap, 4, 0)
    assert not d.any() and not dr.any() and not q.any()
    assert torch.equal(tok, cap)


def test_classes_build_equal_arrays():
    bw = np.random.default_rng(17).integers(200, 4000, size=4096)
    port = tsd.DeviceSaturate(bw, device="cpu")
    ref = jsd.DeviceSaturate(bw)
    np.testing.assert_array_equal(port.refill, ref.refill)
    np.testing.assert_array_equal(port.capacity, ref.capacity)
    assert (port.size, port.qcap_pkts) == (ref.size, ref.qcap_pkts) \
        == (SIZE, 1024)


def test_closed_form_rates():
    bw = np.array([489, 4882], dtype=np.int64)   # ~500 and ~5000 B/tick
    sat = tsd.DeviceSaturate(bw, device="cpu")
    n = np.array([4000, 4000], dtype=np.int64)
    delivered, dropped, queue, _tok = sat.run_device(
        np.zeros(2, dtype=np.int64), n, 30_000)
    assert (queue == 0).all()
    assert delivered[0] + dropped[0] == 4000
    assert delivered[1] == 4000 and dropped[1] == 0
    assert 2000 < delivered[0] < 4000
    assert dropped[0] > 500


@pytest.mark.parametrize("bw_kibps,expect_drops", [(489, True),
                                                   (4882, False)])
def test_engine_cross_check_through_the_port(bw_kibps, expect_drops):
    """The port's model counts equal the port's own engine's for a blast
    source (1 x 958 B datagram per ms, 4,000 in all) into a receiver whose
    downlink bucket and static drop-tail router are the state the model
    mirrors (the JAX package's test, run through shadow_tpu_torch)."""
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.options import Options

    topo = """<?xml version="1.0" encoding="UTF-8"?>
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
<key id="lat" for="edge" attr.name="latency" attr.type="double"/>
<key id="bd" for="node" attr.name="bandwidthdown" attr.type="int"/>
<key id="bu" for="node" attr.name="bandwidthup" attr.type="int"/>
<graph edgedefault="undirected">
<node id="n0"><data key="bd">1048576</data><data key="bu">1048576</data></node>
<edge source="n0" target="n0"><data key="lat">10.3</data></edge>
</graph></graphml>"""
    n_pkts = 4000
    xml = textwrap.dedent(f"""\
        <shadow stoptime="30">
          <topology><![CDATA[{topo}]]></topology>
          <plugin id="source" path="python:source" />
          <plugin id="sink" path="python:sink" />
          <host id="src" bandwidthdown="1048576" bandwidthup="1048576">
            <process plugin="source" starttime="2"
                     arguments="source dst 9000 {n_pkts} {PAYLOAD} 0.001" />
          </host>
          <host id="dst" bandwidthdown="{bw_kibps}" bandwidthup="1048576">
            <process plugin="sink" starttime="1" arguments="sink 9000" />
          </host>
        </shadow>
    """)
    cfg = configuration.parse_xml(xml)
    ctrl = Controller(Options(scheduler_policy="global", workers=0,
                              stop_time_sec=30, router_queue="static",
                              device="cpu"), cfg)
    assert ctrl.run() == 0
    sink = ctrl.engine.host_by_name("dst").processes[0].app_state
    sat = tsd.DeviceSaturate(np.array([bw_kibps], dtype=np.int64),
                             device="cpu")
    delivered, dropped, queue, _tok = sat.run_device(
        np.zeros(1, dtype=np.int64), np.array([n_pkts], dtype=np.int64),
        27_000)
    assert queue[0] == 0
    assert sink.received == delivered[0]
    assert n_pkts - sink.received == dropped[0]
    assert (dropped[0] > 0) == expect_drops
