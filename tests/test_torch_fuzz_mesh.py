"""The port's fuzz runner runs a spec's mesh modes, equal to the JAX
package's, on the CPU.

Fuzz seed 1 (a cdn scenario whose chains cross shards) draws D = 3 for its
``mesh``, ``mesh-fused`` and ``mesh-ppermute`` modes and its ``mesh-lost``
drill (a device lost mid-run, the plane re-sharded).  Each mode goes through
the port's ``run_one_mode`` on ``--device cpu`` (D shards of the one
device) and through the JAX package's ``run_one_mode`` on JAX's 8 virtual
CPU devices: rc, digest, events, rounds, the supervision counts and the
``mesh.*`` scrape must be equal.  ``mesh.cost_model`` differs by design
(the JAX package refuses its checked-in COSTMODEL.json on this box, the port
finds no model of its own and never reads the JAX package's) and is left
out.
"""

import pytest

from shadow_tpu.fuzz.gen import draw_spec as jax_draw_spec
from shadow_tpu.fuzz.runner import run_one_mode as jax_run_one_mode
from shadow_tpu_torch.fuzz.gen import draw_spec
from shadow_tpu_torch.fuzz.runner import run_one_mode

SEED = 1
MESH_MODES = ("mesh", "mesh-fused", "mesh-ppermute", "mesh-lost")
KEYS = ("rc", "digest", "events", "rounds")


def _mode(spec, name):
    return next(m for m in spec["modes"] if m["name"] == name)


def _counts(result):
    """The supervision summary's counts (its ``*_sec`` entries are wall
    time)."""
    return {k: v for k, v in result["supervision"].items()
            if not k.endswith("_sec")}


@pytest.mark.parametrize("name", MESH_MODES)
def test_mesh_mode_runs_and_equals_jax(name):
    spec = draw_spec(SEED)
    assert spec == jax_draw_spec(SEED)
    mode = _mode(spec, name)
    assert int(mode["tpu_devices"]) > 1
    got = run_one_mode(spec, mode, device="cpu")
    want = jax_run_one_mode(spec, mode)
    assert got["skipped"] is None and want["skipped"] is None
    assert got["rc"] == 0, got["log_tail"]
    for key in KEYS:
        assert got[key] == want[key], key
    assert _counts(got) == _counts(want)
    mesh = {k: v for k, v in got["scrape"].items()
            if k.startswith("mesh.") and k != "mesh.cost_model"}
    ref = {k: v for k, v in want["scrape"].items()
           if k.startswith("mesh.") and k != "mesh.cost_model"}
    assert mesh == ref
    assert mesh["mesh.devices"] >= 2 and mesh["mesh.host_bounces"] == 0
    if name != "mesh-lost":
        assert mesh["mesh.cross_shard_cells"] > 0
