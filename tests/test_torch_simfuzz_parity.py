"""simfuzz's regression corpus through the JAX package and the port, on
the CPU.

Each of the 7 corpus specs goes through the JAX package's ``run_modes``
(JAX's 8 virtual CPU devices, tests/conftest.py) and through the port's
``run_modes(spec, device="cpu")``: per mode, rc, skipped, digest, events,
rounds, the supervision counts (its ``*_sec`` entries are wall time) and
the scrape must be equal, and neither run may break an oracle.  The scrape
leaves out ``mesh.cost_model``, which differs by design (the JAX package
refuses its checked-in COSTMODEL.json on this box; the port finds no model
of its own; see tests/test_torch_fuzz_mesh.py).  The same runs hold
``chip_smoke.EXPECTED_CORPUS`` (what the card's corpus replay must give),
and the JAX package's ``base`` run of fuzz seed 1 holds
``chip_smoke.EXPECTED_FUZZ`` (what its batched seed must give).  The
smoke's batched part runs seed 1 alone: seed 2, with its ``procs`` modes,
added ~30 s to a smoke that must stay well inside its time limit.
"""

import json
import os

import pytest

import chip_smoke
from shadow_tpu.fuzz.gen import draw_spec as jax_draw_spec
from shadow_tpu.fuzz.oracles import check as jax_check
from shadow_tpu.fuzz.runner import run_modes as jax_run_modes
from shadow_tpu.fuzz.runner import run_one_mode as jax_run_one_mode
from shadow_tpu_torch.fuzz import cli as fuzz_cli
from shadow_tpu_torch.fuzz.gen import draw_spec
from shadow_tpu_torch.fuzz.oracles import check
from shadow_tpu_torch.fuzz.runner import run_modes

FILES = [os.path.basename(p) for p in
         fuzz_cli.corpus_files(fuzz_cli.CORPUS_DIR)]
KEYS = ("mode", "rc", "skipped", "digest", "events", "rounds")


def _comparable(result):
    out = {k: result[k] for k in KEYS}
    out["supervision"] = {k: v for k, v in
                          (result["supervision"] or {}).items()
                          if not k.endswith("_sec")}
    out["scrape"] = {k: v for k, v in result["scrape"].items()
                     if k != "mesh.cost_model"}
    return out


def test_corpus_is_the_seven_files():
    assert len(FILES) == 7
    assert sorted(f[:-5] for f in FILES) == sorted(chip_smoke.EXPECTED_CORPUS)


@pytest.mark.parametrize("name", FILES)
def test_corpus_spec_equals_jax(name):
    with open(os.path.join(fuzz_cli.CORPUS_DIR, name)) as f:
        spec = json.load(f)["spec"]
    want = jax_run_modes(spec)
    got = run_modes(spec, device="cpu")
    assert [r["mode"] for r in got] == [m["name"] for m in spec["modes"]]
    for g, w in zip(got, want):
        assert g["rc"] == 0 and g["skipped"] is None, g["log_tail"]
        assert _comparable(g) == _comparable(w), g["mode"]
    assert check(spec, got) == []
    assert jax_check(spec, want) == []
    # what the card must give: every mode one digest and event count
    digest, events = chip_smoke.EXPECTED_CORPUS[name[:-5]]
    assert {(r["digest"], r["events"]) for r in want} == {(digest, events)}


@pytest.mark.parametrize("seed", sorted(chip_smoke.EXPECTED_FUZZ))
def test_expected_fuzz_is_the_jax_base_run(seed):
    spec = draw_spec(seed)
    assert spec == jax_draw_spec(seed)
    base = spec["modes"][0]
    assert base["name"] == "base"
    want = jax_run_one_mode(spec, base)
    assert want["rc"] == 0
    assert chip_smoke.EXPECTED_FUZZ[seed] == (want["digest"], want["events"])
