"""Every cell of the benchmark, run from its command line but on the CPU
(``--device cpu``, the program's plain versions) at a tiny size, held to
the plain reference; the control (the program at a 2 ms tick) refused;
and no module of JAX or of the JAX package loaded by a run."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import benchcopy  # noqa: E402

CELLS = [w["name"] for w in benchcopy.bench(benchcopy.REPO)["workloads"]]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return benchcopy.tiny_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_dry_run_is_correct(tiny, cell):
    rc, result, err = benchcopy.run_cli(tiny, cell)
    assert rc == 0, err[-2000:]
    assert result["correct"] is True, result
    assert result["attempted"] >= 1 and result["failed"] == 0
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    e2e = {m["name"] for m in benchcopy.bench(tiny)["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == e2e
    # the check's numbers are the last lines of standard error
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in tail)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(tiny, cell):
    rc, result, err = benchcopy.run_cli(tiny, cell, extra=["--control", "1"])
    assert rc == 0, err[-2000:]
    assert result["correct"] is False
    assert result["checks"]["answers_off"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_and_control_on_the_card(tiny, cell):
    """The kernels at the tiny size: a sound run is correct, the control
    (a 2 ms tick) is refused."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the port's kernels)")
    rc, result, err = benchcopy.run_cli(tiny, cell, device="cuda")
    assert rc == 0 and result["correct"] is True, err[-2000:]
    assert result["device"]["platform"] == "gpu"
    rc, result, err = benchcopy.run_cli(tiny, cell, device="cuda",
                                        extra=["--control", "1"])
    assert rc == 0 and result["correct"] is False, err[-2000:]


def test_traced_dry_run_reports_per_layer_metrics(tiny):
    rc, result, err = benchcopy.run_cli(tiny, "tor100k.web",
                                        extra=["--trace", "1"])
    assert rc == 0, err[-2000:]
    assert result["correct"] is True
    # the CPU has no trace: the card's metrics find nothing to read
    assert set(result["metrics"]) == {"episode_setup_s", "plane_wait_ms"}


def test_no_card_no_result(tiny):
    """Without a card (the default --device cuda) a run prints nothing and
    fails; decided here, by the run itself, not at import."""
    import subprocess
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go ahead")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tiny, env=dict(os.environ, PYTHONPATH=benchcopy.REPO),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ has no program
    to run: the run fails and prints no result."""
    benchcopy.tiny_copy(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from portbench.run import forbidden_modules
    import types
    for name in ("shadow_tpu_torch", "shadow_tpu_torch.core", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "shadow_tpu.core",
                        types.ModuleType("shadow_tpu.core"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert forbidden_modules() == ["jaxlib", "shadow_tpu"]


def test_a_reader_that_loads_the_jax_package_stops_the_result(tmp_path):
    """A metric's reader runs after the window; one that imports the JAX
    package (here a stand-in of that name) leaves no result line."""
    import json
    root = benchcopy.tiny_copy(str(tmp_path))
    os.makedirs(os.path.join(root, "shadow_tpu"))
    with open(os.path.join(root, "shadow_tpu", "__init__.py"), "w") as f:
        f.write("STANDIN = True\n")
    with open(os.path.join(root, "portbench", "metrics", "planted.py"),
              "w") as f:
        f.write("def read(ctx):\n    import shadow_tpu\n"
                "    return 1.0 if shadow_tpu.STANDIN else None\n")
    bench = benchcopy.bench(root)
    bench["end_to_end"].append({
        "name": "planted", "unit": "count", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["tor100k.web"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, result, err = benchcopy.run_cli(root, "tor100k.web")
    assert rc != 0 and result is None, err[-2000:]
    assert "shadow_tpu loaded by the check or the metrics' readers" in err


def test_reference_imports_nothing_of_the_program():
    """The reference and the comparison are plain numpy and torch: their
    imports name no module of the program, of JAX or of the JAX package."""
    import ast
    here = os.path.join(benchcopy.REPO, "portbench")
    for name in ("reference.py", "check.py", "roofline.py",
                 "tests/star_reference.py"):
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in (
                    "shadow_tpu_torch", "shadow_tpu", "jax", "jaxlib",
                    "flax"), (name, m)
