"""Case (b) and (d): a small tor_network (10 relays, 10 clients, 2 servers)
on a seeded 12-vertex complete lossy GraphML.  The port's ``tpu`` runs,
serial and with ``workers=2``, must give the JAX package's ``tpu`` run's
state digest, event count, round count and drop count exactly, and every
hop batch must have gone through the kernel wrapper (``device_calls > 0``,
``host_calls == 0``)."""

import pytest

from test_torch_tpu_policy import PARITY, run, small_tor_xml


@pytest.fixture(scope="module")
def jax_tor():
    xml, graph = small_tor_xml()
    return run("jax", xml, "tpu", topology_text=graph)


@pytest.mark.parametrize("workers", [0, 2])
def test_small_tor_port_tpu_equals_jax_tpu(jax_tor, workers):
    xml, graph = small_tor_xml()
    port = run("torch", xml, "tpu", topology_text=graph, workers=workers)
    assert jax_tor["drops"] > 0, "the topology must drop packets"
    for key in PARITY:
        assert port[key] == jax_tor[key], key
    assert port["device_calls"] > 0
    assert port["host_calls"] == 0


def test_small_tor_port_global_equals_jax_tpu(jax_tor):
    xml, graph = small_tor_xml()
    port = run("torch", xml, "global", topology_text=graph)
    for key in PARITY:
        assert port[key] == jax_tor[key], key
