"""The port's fleet plane on the CPU, against its own serial runs and the
JAX package.

The mixed fleet of ``tests/test_fleet.py`` — star, tor and phold scenarios
drawn by the fuzz generator (seeds 11, 21, 3) plus seed 3's checkpoint +
``--resume`` lane — runs through the port's ``FleetDriver`` on
``--device cpu`` (the batched kernels' plain version), concurrently over
one shared plane.  Every lane's digest, rc, events, skip and scrape equal
the port's serial run of the same mode and the JAX package's
``run_one_mode``.  Then the re-arm drill (a new lane on the same plane
launches no new shape: ``fleet.compiles`` stays flat), the plane's device
check, and the ``simfleet`` parser.
"""

import pytest

from shadow_tpu.fuzz.gen import draw_spec as jax_draw_spec
from shadow_tpu.fuzz.runner import run_one_mode as jax_run_one_mode
from shadow_tpu_torch.fleet import FleetDriver, FleetPlane
from shadow_tpu_torch.fleet.cli import (budget_problems, build_parser,
                                        load_fleet_budget)
from shadow_tpu_torch.fuzz.gen import draw_spec
from shadow_tpu_torch.fuzz.runner import mode_batchable, run_one_mode

SEEDS = (11, 21, 3)
PARITY_KEYS = ("digest", "rc", "events", "skipped", "scrape")


def _mode(spec, resume=False):
    for m in spec["modes"]:
        if mode_batchable(spec, m) and bool(m.get("resume")) == resume:
            return m
    raise AssertionError(
        f"seed {spec['seed']}: no batchable mode with resume={resume}")


@pytest.fixture(scope="module")
def fleet_run():
    specs = {s: draw_spec(s) for s in SEEDS}
    meta = [(s, _mode(specs[s])) for s in SEEDS]
    meta.append((3, _mode(specs[3], resume=True)))
    serial = [run_one_mode(specs[s], m, device="cpu") for s, m in meta]
    jax_specs = {s: jax_draw_spec(s) for s in SEEDS}
    ref = [jax_run_one_mode(jax_specs[s], m) for s, m in meta]
    driver = FleetDriver(lanes=4, plane=FleetPlane(device="cpu"))
    jobs = [lambda lane, s=specs[s], m=m: run_one_mode(s, m, lane=lane,
                                                       device="cpu")
            for s, m in meta]
    fleet = driver.run(jobs)
    return {"specs": specs, "jax_specs": jax_specs, "meta": meta,
            "serial": serial, "jax": ref, "fleet": fleet, "driver": driver}


def test_specs_equal_jax_specs(fleet_run):
    assert fleet_run["specs"] == fleet_run["jax_specs"]


@pytest.mark.parametrize("lane", range(4))
def test_fleet_lane_equals_serial_and_jax(fleet_run, lane):
    """Each lane (the last is the resume drill) lands the exact digest,
    rc, events and scrape of the port's serial run and the JAX run."""
    seed, mode = fleet_run["meta"][lane]
    got = fleet_run["fleet"][lane]
    assert got["rc"] == 0, got["log_tail"]
    assert not got["skipped"]
    for key in PARITY_KEYS:
        assert got[key] == fleet_run["serial"][lane][key], (seed, key)
        assert got[key] == fleet_run["jax"][lane][key], (seed, key)
    if lane == 3:
        assert mode.get("resume")


def test_fleet_really_batched(fleet_run):
    fams = {fleet_run["specs"][s]["family"] for s, _ in fleet_run["meta"]}
    assert fams == {"star", "tor", "phold"}
    stats = fleet_run["driver"].plane.metrics()
    assert stats["fleet.launches"] > 0
    assert stats["fleet.lane_dispatches"] >= stats["fleet.launches"]
    assert stats["fleet.shape_classes"] >= 2
    assert stats["fleet.launches_amortized"] >= 1.0
    assert 0.0 < stats["fleet.lane_occupancy"] <= 1.0
    assert not budget_problems(stats["fleet.compiles"], load_fleet_budget())


def test_rearm_launches_no_new_shape(fleet_run):
    """A finished lane re-armed with a same-class scenario on the same
    plane: more launches, no new (class, width) launch shape."""
    driver = fleet_run["driver"]
    spec = fleet_run["specs"][11]
    before = driver.plane.metrics()
    got = driver.run([lambda lane: run_one_mode(spec, _mode(spec),
                                                lane=lane, device="cpu")])[0]
    after = driver.plane.metrics()
    assert got["digest"] == fleet_run["serial"][0]["digest"]
    assert after["fleet.compiles"] == before["fleet.compiles"]
    assert after["fleet.launches"] > before["fleet.launches"]


def test_lane_on_another_device_is_refused(monkeypatch):
    """A lane whose device plane runs on another device than the fleet's
    is refused at attach (its run then ends with rc -1); a cuda fleet
    without a card raises instead of running on the CPU."""
    import torch

    class _Other:
        device = torch.device("cuda", 7)
    lane = FleetPlane(device="cpu").lane()
    with pytest.raises(ValueError, match="fleet plane on cpu"):
        lane.attach_plane(_Other())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FleetPlane(device="cuda")


def test_cli_parser_surface():
    args = build_parser().parse_args(["smoke", "--lanes", "2",
                                      "--seeds", "3"])
    assert args.lanes == 2 and args.seeds == 3 and not args.numpy
    assert args.device == "cuda"
    assert build_parser().parse_args(
        ["smoke", "--device", "cpu"]).device == "cpu"
    assert load_fleet_budget() == 64
    assert budget_problems(0, 64) and budget_problems(65, 64)
    assert not budget_problems(3, 64) and not budget_problems(0, None)
