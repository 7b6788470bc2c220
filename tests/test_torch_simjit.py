"""simjit in the port (shadow_tpu_torch/analysis/simjit.py, jit_rules.py):
the build-and-sync surface of the hand-written CUDA kernels.

* the port is clean: 0 unsuppressed findings over ``shadow_tpu_torch/``,
  every pragma in use, and the designed sync sites (pragma'd SIM302
  collects, reads of an in-flight handle, explicit syncs) listed for the
  card's sync audit;
* SIM301 and SIM304 are listed as not applicable and run no check;
* SIM302 fires on each implicit sync of a live device value (a kernel
  wrapper's result and what derives from it) and stays quiet on a handle's
  attribute and on host values; SIM303 in torch and CUDA spelling; SIM305
  on the build budget;
* parity: the port's SIM303 over the JAX package's kernel files gives the
  JAX package's findings, clean and on a drifted copy;
* the budget's runtime keys are the ones ``simfleet smoke`` checks.
"""

from __future__ import annotations

import os
import shutil
import textwrap

import pytest

from shadow_tpu.analysis import jit_rules as jax_jit_rules
from shadow_tpu.analysis import simjit as jax_simjit
from shadow_tpu_torch.analysis import jit_rules, simjit, simlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules_of(findings):
    return sorted({f.rule for f in findings if not f.suppressed})


@pytest.fixture(scope="module")
def port_jit():
    config, budget, kernel, sync = simjit.load_jit_config(
        os.path.join(REPO, "pyproject.toml"))
    pkg: list = []
    result = simjit.jit_paths([os.path.join(REPO, "shadow_tpu_torch")],
                              config, budget=budget, kernel=kernel,
                              sync=sync, package=pkg)
    return result, pkg[0]


def test_simjit_finds_nothing_in_the_port(port_jit):
    result, pkg = port_jit
    report = result.to_json()
    assert report["findings"] == [], report["findings"]
    assert report["summary"]["suppressed"] > 0
    assert {f["rule"] for f in report["suppressed"]} == {"SIM302"}
    # the CUDA sources are among the files read (SIM303's kernel plane)
    assert len(pkg.cuda) == 12
    assert pkg.is_sync("shadow_tpu_torch/parallel/device_plane.py")


def test_build_budget_counts_the_port(port_jit):
    _result, pkg = port_jit
    names, _node = pkg.kernels["shadow_tpu_torch/ops/_build.py"]
    assert len(names) == pkg.budget["shadow_tpu_torch/ops/_build.py"] == 10
    bound = {rel: {(b.kernel, b.symbol) for b in bs}
             for rel, bs in pkg.bindings.items() if bs}
    assert bound["shadow_tpu_torch/ops/round_step.py"] == {
        ("packet_hop", "packet_hop_launch"),
        ("packet_hop", "packet_hop_map_host"),
        ("packet_hop_sharded", "packet_hop_sharded_launch")}
    for rel, pairs in bound.items():
        assert pkg.budget[rel] == len(pairs), rel
    assert {k for pairs in bound.values() for k, _s in pairs} == set(names)


def test_sync_inventory_lists_the_designed_sites(port_jit):
    result, pkg = port_jit
    sites = jit_rules.sync_inventory(pkg, result.findings)
    by = {(s.path.rsplit("/", 1)[-1], s.call, s.handle) for s in sites}
    assert ("device_plane.py", ".synchronize()", True) in by  # _FlushHandle
    assert ("round_step.py", ".synchronize()", True) in by    # HopHandle
    assert ("plane.py", ".cpu()", False) in by      # the fleet's collect
    pragma = {(f.path, f.line) for f in result.suppressed}
    assert all(s.handle or (s.path, s.line) in pragma
               or any(p == s.path and s.line <= ln <= s.end_line
                      for p, ln in pragma) for s in sites)


def test_not_applicable_rules_are_listed_and_run_nothing(capsys):
    assert simjit.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("SIM301", "SIM304"):
        line = next(ln for ln in out.splitlines() if ln.startswith(rid))
        assert "n/a" in line and "not applicable in the port" in line
    na = [r for r in jit_rules.CATALOG if not r.applicable]
    assert sorted(r.id for r in na) == ["SIM301", "SIM304"]
    assert all(r.run(None) == [] for r in na)


# ---------------------------------------------------------------------------
# SIM302 / SIM303 / SIM305 fixtures

_BUILD = '''
KERNELS = ("k",)

def entry(name, symbol, argtypes):
    pass
'''
_OPS = '''
import torch
from ._build import entry

def k_wrapper(x):
    out = torch.empty(4, dtype=torch.int64, device=x.device)
    entry("k", "k_launch", [])(x.data_ptr(), out.data_ptr())
    k_wrapper.launches += 1
    return out

def step(x):
    return k_wrapper(x) + 1
'''
SYNC = ["pkg/plane.py"]
KERNEL = ["pkg/ops/*.py", "pkg/ops/csrc/*.cu"]


def _jit(plane_src, extra=None, budget=None):
    sources = {"pkg/ops/_build.py": _BUILD, "pkg/ops/k.py": _OPS,
               "pkg/plane.py": textwrap.dedent(plane_src)}
    sources.update(extra or {})
    return simjit.jit_sources(
        sources, simlint.Config(), budget=budget if budget is not None
        else {"pkg/ops/_build.py": 1, "pkg/ops/k.py": 1},
        kernel=KERNEL, sync=SYNC)


@pytest.mark.parametrize("line", [
    "n = out.item()", "n = out.tolist()", "n = out.cpu()",
    "n = out.numpy()", "n = int(out[0])", "n = bool(out.sum())",
    "n = np.asarray(out)", "n = torch.nonzero(out)",
    "n = torch.where(out > 0)", "n = out[out > 0]",
    "torch.cuda.synchronize()", "n = [v.item() for v in out]",
])
def test_sim302_fires_on_each_sync_of_a_kernel_result(line):
    out = _jit(f"""
        import numpy as np
        import torch
        from .ops.k import step

        def collect(x):
            out = step(x)
            {line}
            return out
    """)
    assert _rules_of(out) == ["SIM302"], [f.render() for f in out]


def test_sim302_branch_on_a_device_value_and_pragma():
    out = _jit("""
        from .ops.k import step

        def go(x):
            out = step(x)
            if out.sum():
                return 1
            # simjit: disable=SIM302 -- the designed collect of this fixture
            return out.cpu()
    """)
    assert _rules_of(out) == ["SIM302"]
    assert [f.suppressed for f in out if f.rule == "SIM302"] == [False, True]


def test_sim302_quiet_on_handles_host_values_and_other_modules():
    quiet = """
        import numpy as np
        import torch
        from .ops.k import step

        class Handle:
            def wait(self):
                self._event.synchronize()
                return self._buf.numpy().copy()

        def host(a):
            b = np.asarray(a)
            t = torch.from_numpy(b)
            return int(t.sum()), t.tolist(), len(step(a).shape)

        def scoped(x, host_rows):
            kept = [v for v in step(x)]
            # a comprehension's variable is its own: here it is host data
            return kept, [np.asarray(v) for v in host_rows]
    """
    assert _jit(quiet) == []
    # the same syncs outside the sync-audited modules are not SIM302's
    out = _jit("def noop():\n    pass\n",
               extra={"pkg/other.py": textwrap.dedent("""
                   from .ops.k import step

                   def collect(x):
                       return step(x).item()
               """)})
    assert out == []


def test_sim303_fires_in_torch_and_cuda_spelling():
    ops = _OPS + textwrap.dedent('''
        def bad(deliver_ns, arrive_time):
            a = deliver_ns / 2
            b = deliver_ns.float()
            c = arrive_time.to(torch.float64)
            d = deliver_ns * 0.5
            return a, b, c, d
    ''')
    cu = ("__device__ double f(int64_t deliver_ns) {\n"
          "  return (double)deliver_ns + __ll2float_rn(deliver_ns);\n}\n"
          "__device__ int64_t g(int64_t send_ns) {\n"
          "  // simjit: disable=SIM303 -- a fixture's designed cast\n"
          "  return (int64_t)((float)send_ns);\n}\n")
    out = _jit("def noop():\n    pass\n",
               extra={"pkg/ops/k.py": ops, "pkg/ops/csrc/k.cu": cu})
    fired = [f for f in out if f.rule == "SIM303" and not f.suppressed]
    assert sorted((f.path, f.line) for f in fired) == [
        ("pkg/ops/csrc/k.cu", 2), ("pkg/ops/csrc/k.cu", 2),
        ("pkg/ops/k.py", 15), ("pkg/ops/k.py", 16), ("pkg/ops/k.py", 17),
        ("pkg/ops/k.py", 18)]
    assert [f.suppressed for f in out
            if f.path.endswith(".cu") and f.line == 6] == [True]


def test_sim305_budget_drift_and_unenumerable_bindings():
    ok = _jit("def noop():\n    pass\n")
    assert ok == []
    grew = _jit("def noop():\n    pass\n",
                budget={"pkg/ops/_build.py": 1, "pkg/ops/k.py": 0})
    assert _rules_of(grew) == ["SIM305"]
    stale = _jit("def noop():\n    pass\n",
                 budget={"pkg/ops/_build.py": 1, "pkg/ops/k.py": 1,
                         "pkg/ops/gone.py": 2})
    assert _rules_of(stale) == ["SIM305"]
    assert stale[0].path == jit_rules.BUDGET_ANCHOR
    odd = _jit("def noop():\n    pass\n", extra={
        "pkg/ops/m.py": "from ._build import entry\n"
                        "def f(n):\n    return entry(n, 'x', [])\n"
                        "def g():\n    return entry('zz', 'z_launch', [])\n"},
        budget={"pkg/ops/_build.py": 1, "pkg/ops/k.py": 1,
                "pkg/ops/m.py": 1})
    msgs = [f.message for f in odd if f.rule == "SIM305"]
    assert any("non-literal" in m for m in msgs)
    assert any("`zz`" in m for m in msgs)


def test_a_cuda_file_that_does_not_parse_is_sim000(tmp_path):
    src = tmp_path / "pkg" / "ops" / "csrc"
    os.makedirs(src)
    (src / "k.cu").write_text("__global__ void k() {\n")
    (tmp_path / "pyproject.toml").write_text("[tool.simlint]\n")
    result = simjit.jit_paths([str(tmp_path / "pkg")],
                              simlint.load_config(
                                  str(tmp_path / "pyproject.toml")),
                              budget={}, kernel=KERNEL, sync=SYNC)
    assert [(f.rule, f.path) for f in result.findings] == [
        ("SIM000", "pkg/ops/csrc/k.cu")]


# ---------------------------------------------------------------------------
# SIM303 parity with the JAX package on its kernel files

_JAX_KERNEL = ["shadow_tpu/ops/*.py", "shadow_tpu/parallel/mesh/*.py",
               "shadow_tpu/fleet/plane.py"]


def _kernel_files(root):
    import glob
    out = []
    for pat in _JAX_KERNEL:
        out += glob.glob(os.path.join(root, pat))
    return sorted(out)


def _both_sim303(root):
    files = _kernel_files(root)
    cfg = str(root / "pyproject.toml") if not isinstance(root, str) \
        else os.path.join(root, "pyproject.toml")
    ref = jax_simjit.jit_paths(
        files, jax_simjit.load_config(cfg),
        rules=[jax_jit_rules.PromotionDriftRule()], budget={},
        kernel=_JAX_KERNEL)
    port = simjit.jit_paths(
        files, simlint.load_config(cfg, port=False),
        rules=[jit_rules.PromotionDriftRule()], budget={},
        kernel=_JAX_KERNEL, sync=[])
    return port.to_json(), ref.to_json()


def test_sim303_parity_on_the_jax_kernel_files():
    port, ref = _both_sim303(REPO)
    assert port == ref and ref["files"] > 10


def test_sim303_parity_on_drifted_jax_kernel_files(tmp_path):
    for sub in ("ops", "parallel/mesh", "fleet"):
        shutil.copytree(os.path.join(REPO, "shadow_tpu", sub),
                        tmp_path / "shadow_tpu" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "pyproject.toml"),
                tmp_path / "pyproject.toml")
    path = tmp_path / "shadow_tpu/ops/bandwidth.py"
    path.write_text(path.read_text() + textwrap.dedent("""

        def _drift(deliver_ns, send_times):
            return deliver_ns / 2, send_times * 0.5, \\
                deliver_ns.astype(jnp.float32)
    """))
    port, ref = _both_sim303(tmp_path)
    assert port == ref
    assert ref["summary"]["by_rule"] == {"SIM303": 3}


def test_runtime_budget_is_the_one_simfleet_checks():
    from shadow_tpu_torch.fleet.cli import load_runtime_budget
    _config, budget, _kernel, _sync = simjit.load_jit_config(
        os.path.join(REPO, "pyproject.toml"))
    runtime = {k: v for k, v in budget.items() if not k.endswith(".py")}
    assert runtime == load_runtime_budget()
    assert runtime["fleet.compiles"] > 0
