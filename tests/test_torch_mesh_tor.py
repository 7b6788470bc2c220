"""The port's sharded traffic plane on the tor config of
tests/test_meshplane.py (8 relays, 5 device-mode clients, 2 servers, stream
512:20200, stop 60): circuit set-up through the real engine, the bulk phase
on D = 8 shards (``--device cpu``: the plain mesh version).  At K = 1 and
K = 8 the port's run gives the JAX package's sharded run's digest, events,
rounds, forwards, completed flows, dispatches and ``mesh.*`` metrics, and
the port's single-table run's digest, with the exchange on the device
side (``mesh.host_bounces == 0``)."""

import pytest

from shadow_tpu_torch.tools import workloads
from test_torch_mesh_plane import assert_equal_runs, assert_mesh_contract, run

TOR_XML = workloads.tor_network(8, n_clients=5, n_servers=2, stoptime=60,
                                stream_spec="512:20200", device_data=True)


@pytest.mark.parametrize("k", [1, 8])
def test_tor_sharded_equals_jax_and_single(k):
    port = run("torch", TOR_XML, 60, tpu_devices=8, superwindow_rounds=k)
    assert_mesh_contract(port)
    assert_equal_runs(port, run("jax", TOR_XML, 60, tpu_devices=8,
                                superwindow_rounds=k))
    single = run("torch", TOR_XML, 60, tpu_devices=1)
    assert port["digest"] == single["digest"]
    assert port["completed"] == 5
