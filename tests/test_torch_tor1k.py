"""The tor1k slice at full size on the CPU (marker ``slow``: two runs of
about a minute each, outside the tier-1 gate).

This is how chip_smoke.py's EXPECTED constants were made and how to remake
them: the JAX package's ``tpu`` run of chip_smoke's tor1k config (2,050
hosts on the seeded 183-vertex complete lossy GraphML, stoptime 20) gives
the state digest, events, rounds, drops and hop launches; the port's own
``tpu`` run on the CPU must give the same.  Run with
``python -m pytest -m slow tests/test_torch_tor1k.py``.
"""

import pytest

import chip_smoke
from test_torch_tpu_policy import run

pytestmark = pytest.mark.slow


def _tor1k():
    from shadow_tpu.tools.workloads import tor_network
    from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
    t = chip_smoke.TOR1K
    return (tor_network(t["n_relays"], stoptime=t["stoptime"]),
            lossy_complete_graphml(t["graph_vertices"], t["graph_seed"]))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_tor1k_tpu_run_matches_chip_smoke_constants(pkg):
    xml, graph = _tor1k()
    out = run(pkg, xml, "tpu", topology_text=graph,
              seed=chip_smoke.TOR1K["seed"])
    expected = chip_smoke.EXPECTED
    for key in ("digest", "events", "rounds", "drops", "device_calls"):
        assert out[key] == expected[key], key
    assert out["host_calls"] == 0
