"""The port stands alone: it imports torch and never jax, and nothing of
``shadow_tpu``; ``shadow_tpu`` never imports torch; ``--device cuda``
without a card raises instead of running on the CPU; and every module the
port keeps as a verbatim copy still equals its ``shadow_tpu`` original once
the import prefix is normalised (so the copies are copies, and drift on
either side shows here)."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

import shadow_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "shadow_tpu_torch")
REF = os.path.join(REPO, "shadow_tpu")

# modules copied from shadow_tpu unchanged but for the import prefix
VERBATIM = [
    "core/configuration", "core/worker", "core/event", "core/task",
    "core/stime", "core/defs", "core/counters", "core/logger",
    "core/supervision", "core/engine", "core/checkpoint", "core/scheduler",
    "host/host", "host/cpu", "host/network_interface", "host/router",
    "host/tracker",
    "routing/address", "routing/dns", "routing/packet",
    "descriptor/base", "descriptor/tcp", "descriptor/tcp_cong",
    "descriptor/retransmit_tally", "descriptor/udp", "descriptor/signalfd",
    "descriptor/epoll", "descriptor/timer", "descriptor/eventfd",
    "descriptor/channel",
    "process/process", "process/native",
    "apps/tor", "apps/echo", "apps/filetransfer", "apps/phold", "apps/tgen",
    "apps/blast", "apps/httpd", "apps/bitcoin",
    "obs/__init__", "obs/metrics", "obs/trace", "obs/profiler",
    "prof/autotune", "prof/ledger", "prof/__main__",
    "utils/pqueue", "utils/count_down_latch", "utils/pcap",
    "utils/byte_queue",
    "scale/__init__", "scale/memprof", "scale/hosttable", "scale/genscen",
    "tools/workloads", "tools/mkscenario", "tools/trace_report",
    "tools/parse_log", "tools/plot_log",
    "fuzz/__init__", "fuzz/gen",
    "fleet/__init__", "fleet/__main__", "fleet/driver",
    "parallel/mesh/partition", "parallel/procs",
]
# copies that differ from their original only in the named top-level
# functions: the C data plane's loader builds and loads the port's own
# extension (utils/native_build.py), never the JAX package's binaries
CHANGED_FUNCTIONS = {
    "parallel/native_plane": ("_load_module", "_try_import"),
}


def _port_modules():
    names = [shadow_tpu_torch.__name__]
    for info in pkgutil.walk_packages(shadow_tpu_torch.__path__,
                                      prefix="shadow_tpu_torch."):
        # a package's __main__ runs its program when imported; the AST
        # scan below still holds it to the import rule
        if not info.name.endswith(".__main__"):
            names.append(info.name)
    return sorted(names)


def _run_python(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)


def test_every_port_module_imports_without_jax_or_shadow_tpu():
    mods = _port_modules()
    assert len(mods) > 50
    res = _run_python(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "shadow_tpu" or m.startswith("shadow_tpu."))
        assert not bad, bad
        assert "torch" in sys.modules
        print("OK", len({mods!r}))
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK")


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


def test_ast_scan_finds_no_jax_or_shadow_tpu_import():
    seen = 0
    for root, _dirs, files in os.walk(PORT):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                roots = set(_imported_roots(path))
                assert not roots & {"jax", "jaxlib", "shadow_tpu"}, path
                seen += 1
    assert seen > 50
    # the smoke script that drives the port on the card is held to it too
    roots = set(_imported_roots(os.path.join(REPO, "chip_smoke.py")))
    assert not roots & {"jax", "jaxlib", "shadow_tpu"}


def test_import_shadow_tpu_does_not_load_torch():
    res = _run_python("""
        import sys
        import shadow_tpu
        import shadow_tpu.core.controller, shadow_tpu.parallel.tpu_policy
        assert "torch" not in sys.modules, "shadow_tpu imported torch"
        print("OK")
    """)
    assert res.returncode == 0, res.stderr


def test_trace_probe_refuses_without_a_card(monkeypatch):
    import torch
    from shadow_tpu_torch.tools import trace_probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a GPU"):
        trace_probe.main(["--minutes", "0"])


def test_cuda_without_a_card_raises(monkeypatch):
    import torch
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.options import Options, parse_args
    from shadow_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("tpu")
    # cuda is the default of both entry points
    assert Options().device == "cuda"
    assert parse_args(["x.xml"]).device == "cuda"
    assert parse_args(["x.xml", "--device", "cpu"]).device == "cpu"
    cfg = configuration.parse_xml(
        '<shadow stoptime="5"><plugin id="e" path="python:echo" />'
        '<host id="h"><process plugin="e" starttime="1" '
        'arguments="udp server 8000" /></host></shadow>')
    with pytest.raises(RuntimeError, match="cuda"):
        Controller(Options(scheduler_policy="tpu", stop_time_sec=5), cfg)


@pytest.mark.parametrize("module", VERBATIM)
def test_verbatim_copy_equals_original(module):
    with open(os.path.join(PORT, module + ".py"), encoding="utf-8") as f:
        port = f.read()
    with open(os.path.join(REF, module + ".py"), encoding="utf-8") as f:
        ref = f.read()
    assert port.replace("shadow_tpu_torch.", "shadow_tpu.") == ref, (
        f"shadow_tpu_torch/{module}.py drifted from shadow_tpu/{module}.py")


def _without(text: str, names) -> str:
    """``text`` with the top-level functions ``names`` cut out."""
    fns = [n for n in ast.parse(text).body
           if isinstance(n, ast.FunctionDef) and n.name in names]
    assert len(fns) == len(names), names
    cut = {i for n in fns for i in range(n.lineno - 1, n.end_lineno)}
    return "".join(line for i, line in
                   enumerate(text.splitlines(keepends=True)) if i not in cut)


@pytest.mark.parametrize("module", sorted(CHANGED_FUNCTIONS))
def test_changed_copy_equals_original_but_for_its_functions(module):
    with open(os.path.join(PORT, module + ".py"), encoding="utf-8") as f:
        port = f.read()
    with open(os.path.join(REF, module + ".py"), encoding="utf-8") as f:
        ref = f.read()
    names = CHANGED_FUNCTIONS[module]
    port = port.replace("shadow_tpu_torch.", "shadow_tpu.")
    assert _without(port, names) == _without(ref, names), (
        f"shadow_tpu_torch/{module}.py drifted from shadow_tpu/{module}.py "
        f"outside {', '.join(names)}")
    assert port != ref


# the model workloads' modules: each imports with jax and shadow_tpu
# blocked, and keeps its numpy twins as copies of the JAX package's
MODEL_MODULES = ["ops/phold_device", "ops/saturate_device", "ops/bandwidth",
                 "ops/torcells_device", "tools/modelbench",
                 # the cost model, its CLI and ledger, and the log tools
                 "prof/model", "prof/calibrate", "prof/cli", "prof/ledger",
                 "tools/trace_report", "tools/parse_log", "tools/plot_log"]
MODEL_TWINS = [("ops/saturate_device", "saturate_run_numpy"),
               ("ops/phold_device", "phold_run_numpy"),
               ("ops/torcells_device", "torcells_run_numpy"),
               ("ops/torcells_device", "torcells_step_window_numpy"),
               ("ops/bandwidth", "bucket_params")]


@pytest.mark.parametrize("module", MODEL_MODULES)
def test_model_module_imports_with_jax_blocked(module):
    name = "shadow_tpu_torch." + module.replace("/", ".")
    assert name in _port_modules()
    res = _run_python(f"""
        import sys
        for blocked in ("jax", "jaxlib", "shadow_tpu"):
            sys.modules[blocked] = None   # importing it now raises
        import importlib
        importlib.import_module({name!r})
        print("OK")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK")


def _function_source(path, name):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.get_source_segment(text, node)
    raise AssertionError(f"{name} not in {path}")


@pytest.mark.parametrize("module,name", MODEL_TWINS)
def test_model_numpy_twin_equals_original(module, name):
    port = _function_source(os.path.join(PORT, module + ".py"), name)
    ref = _function_source(os.path.join(REF, module + ".py"), name)
    assert port == ref, f"{module}.{name} drifted from shadow_tpu's"


def _sha256(path):
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_port_calibration_leaves_the_jax_records_alone(tmp_path):
    """``python -m shadow_tpu_torch.prof calibrate --quick --device cpu``
    then ``check`` exit 0, and the JAX package's checked-in model and
    history are byte for byte what they were: the port writes files of its
    own names (prof/__init__.py)."""
    records = [os.path.join(REPO, n) for n in ("COSTMODEL.json",
                                               "BENCH_HISTORY.jsonl")]
    before = [_sha256(p) for p in records]
    out = str(tmp_path / "cm.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"     # do not crowd the other test workers
    for args in (["calibrate", "--quick", "--device", "cpu", "--devices",
                  "2", "--out", out], ["check", out]):
        res = subprocess.run([sys.executable, "-m", "shadow_tpu_torch.prof",
                              *args], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=240)
        assert res.returncode == 0, res.stdout + res.stderr
    assert '"loads_on_this_box": true' in res.stdout
    assert [_sha256(p) for p in records] == before
