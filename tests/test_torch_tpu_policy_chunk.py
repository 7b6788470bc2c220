"""Case (c): mid-round chunk launches (``--tpu-chunk``) on the small tor
config.  With a chunk of 1 every hop is launched alone while the round is
still running, so many launches are pending at each barrier; the state
digest, events, rounds and drops must still equal the JAX package's
``tpu`` run."""

import pytest

from test_torch_tpu_policy import PARITY, run, small_tor_xml


@pytest.fixture(scope="module")
def jax_tor():
    xml, graph = small_tor_xml()
    return run("jax", xml, "tpu", topology_text=graph)


@pytest.mark.parametrize("extra", [{"tpu_chunk": 1},
                                   {"tpu_chunk": 7, "workers": 2}])
def test_small_tor_chunked_launches_equal_jax(jax_tor, extra):
    xml, graph = small_tor_xml()
    port = run("torch", xml, "tpu", topology_text=graph, **extra)
    for key in PARITY:
        assert port[key] == jax_tor[key], key
    assert port["host_calls"] == 0
    # one launch per chunk: far more launches than rounds
    assert port["device_calls"] > jax_tor["rounds"]
