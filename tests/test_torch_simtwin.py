"""simtwin in the port (shadow_tpu_torch/analysis/): the cross-plane pass
over the port's own planes, the CUDA kernel plane among them.

* cspec stays the JAX package's byte for byte on the native C plane, and
  cuspec (cspec over the CUDA spelling) reads each of the 12 sources of
  ``ops/csrc`` to a hand-written expectation of its constants and symbols;
* SIM204 for C++ (a sim-time value cast, assigned or stored to 32 bits or
  fewer) fires and takes pragmas, and a CUDA file that does not parse is a
  SIM000 finding, never skipped;
* parity: the port's simtwin over ``shadow_tpu/`` and ``native/`` with the
  repository's settings read as written gives the JAX package's JSON,
  clean and on a drifted copy;
* the port is clean: 0 unsuppressed findings over ``shadow_tpu_torch/``
  and ``native/``, the refill tick, Threefry's parity and rotations and
  the cell's header bytes each compared across the Python, C and CUDA
  planes;
* mutation cases on copies of the tree, one parametrised test: each
  reports its rule (SIM201, SIM203, SIM204, SIM205, SIM302, SIM303,
  SIM305).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import pytest

from shadow_tpu.analysis import cspec as jax_cspec
from shadow_tpu.analysis import simtwin as jax_simtwin
from shadow_tpu.analysis import twin_rules as jax_twin_rules
from shadow_tpu_torch.analysis import cspec, cuspec, simjit, simlint, simtwin
from shadow_tpu_torch.analysis.twin_rules import (C_PROBES, TwinModel,
                                                  parse_map)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "shadow_tpu_torch/ops/csrc"


def _rules_of(findings):
    return sorted({f.rule for f in findings if not f.suppressed})


# ---------------------------------------------------------------------------
# the extractors


@pytest.mark.parametrize("path", ["native/dataplane.cc",
                                  "native/retransmit_tally.cc"])
def test_cspec_reads_the_native_plane_as_the_jax_package_does(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        text = f.read()
    port = dataclasses.asdict(cspec.extract(path, text, C_PROBES))
    ref = dataclasses.asdict(jax_cspec.extract(path, text,
                                               jax_twin_rules.C_PROBES))
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port["symbols"]


# what cuspec must read out of each CUDA source: its folded constants and
# its defined symbols (functions, kernels, structs and the extern "C"
# entries), written down from the sources
CUDA_EXPECT = {
    "admit_sorted.cu": (
        {"THREADS": 256, "LANES": 4, "SPAN": 1024, "HALO": 256, "TILE": 768,
         "WARPS": 8, "RUNS": 3, "LANES_MAX": 4096, "LANE_THREADS": 256,
         "FULL": 0xFFFFFFFF, "REFILL_NS": 1000000,
         "REFILL_MAGIC": 0x431BDE82D7B634DB, "REFILL_SHIFT": 18},
        {"Recip", "Run", "admit_sorted_kernel", "admit_sorted_kernel_lanes",
         "admit_sorted_launch", "block_sum", "clamp_row", "div", "finish",
         "floor_div", "floor_div_wide", "floor_refill", "init", "reset",
         "reset_lane", "step", "walk", "walk_span"}),
    "mesh_span.cu": (
        {"MAX_TARGETS": 64},
        {"MeshParams", "block_sum", "floor_mod", "mesh_span_kernel",
         "mesh_span_launch"}),
    "pack_flush.cu": (
        {"THREADS": 256, "LANES": 4, "TILE": 1024, "WARPS": 8, "HEADER": 5,
         "HDR_TCP": 66, "PACK_CELL_WIRE_BYTES": 578},
        {"BatchedSrc", "Dims", "MeshSrc", "SerialSrc", "Tile", "Totals",
         "Where", "chain", "flush_totals", "header", "launch", "load",
         "make_dims", "node", "pack_body", "pack_flush_batched_kernel",
         "pack_flush_batched_launch", "pack_flush_kernel",
         "pack_flush_launch", "pack_flush_mesh_kernel",
         "pack_flush_mesh_launch", "scan_count", "warp_sums", "where"}),
    "packet_hop.cu": (
        {"THREADS": 256, "WARPS": 8, "FULL": 0xFFFFFFFF, "STAGE": 98},
        {"clamp_row", "packet_hop_kernel", "packet_hop_launch",
         "packet_hop_map_host"}),
    "packet_hop_sharded.cu": (
        {"THREADS": 256, "MAX_SHARDS": 64},
        {"clamp_row", "packet_hop_sharded_kernel",
         "packet_hop_sharded_launch"}),
    "phold.cu": (
        {"THREADS": 1024, "WARPS": 32, "BITS": 32, "PASS": 32768,
         "FULL": 0xFFFFFFFF, "NO_LOOKAHEAD": 1 << 62,
         "SMEM_LIMIT": 220 * 1024},
        {"block_min", "min64", "phold_kernel", "phold_launch", "wrap_add"}),
    "saturate.cu": (
        {"THREADS": 32, "UNROLL": 4},
        {"Narrow", "Out", "clamp64", "floor_div", "min64", "saturate_kernel",
         "saturate_launch", "saturate_narrow", "saturate_wide", "tick"}),
    "span_tile.cuh": (
        {"THREADS": 256, "WARPS": 8, "FPT": 2, "CHUNK": 512,
         "FULL": 0xFFFFFFFF, "HDR_TCP": 66, "CELL_WIRE_BYTES": 578,
         "SEG_HEAD": 1, "NODE_TAIL": 2},
        {"Exchange", "Shared", "Table", "seg_scan", "span_tile"}),
    "threefry.cuh": (
        {"TF_PARITY": 0x1BD11BDA, "TF_ROT": [13, 15, 26, 6, 17, 29, 16, 24]},
        {"rotl32", "threefry2x32_x0"}),
    "torcells_run.cu": (
        {"MAX_THREADS": 1024, "MAX_WARPS": 32, "FULL": 0xFFFFFFFF,
         "HDR_TCP": 66, "CELL_WIRE_BYTES": 578, "SEG_HEAD": 1,
         "NODE_TAIL": 2, "GRID": 0, "GLOBAL": 1},
        {"FlowIn", "Run", "RunParams", "ScanSlots", "floor_div", "load_flow",
         "seg_scan", "tick_flow", "tick_loop", "torcells_run_kernel",
         "torcells_run_launch", "warp_seg_scan", "warp_sum"}),
    "torcells_span.cu": (
        {"MAX_TARGETS": 64},
        {"SpanParams", "block_sum", "floor_mod", "torcells_span_kernel",
         "torcells_span_launch"}),
    "torcells_span_batched.cu": (
        {"MAX_LANES": 256},
        {"BatchParams", "floor_mod", "torcells_span_batched_kernel",
         "torcells_span_batched_launch"}),
}


def test_every_cuda_source_has_an_expectation():
    assert sorted(os.listdir(os.path.join(REPO, CSRC))) == \
        sorted(CUDA_EXPECT)


@pytest.mark.parametrize("name", sorted(CUDA_EXPECT))
def test_cuspec_reads_each_cuda_source(name):
    with open(os.path.join(REPO, CSRC, name), encoding="utf-8") as f:
        text = f.read()
    ext = cuspec.extract(f"{CSRC}/{name}", text)
    constants, symbols = CUDA_EXPECT[name]
    assert {k: v for k, (v, _line) in ext.constants.items()} == constants
    assert set(ext.symbols) == symbols


def test_cuspec_normalize_keeps_offsets_and_blanks_cuda_syntax():
    src = ('template <typename V, bool F = true>\n'
           '__global__ void __launch_bounds__(256, 2) k(int* __restrict__ a)'
           ' {\n'
           '  __shared__ __align__(16) int s[4];\n'
           '  if constexpr (F) { other<<<g, 256, 0, st>>>(a); }\n'
           '#pragma unroll\n'
           '}\n'
           'extern "C" int entry_launch(const void* p) { return 0; }\n')
    norm = cuspec.normalize(src)
    assert len(norm) == len(src) and norm.count("\n") == src.count("\n")
    for gone in ("template", "__global__", "__launch_bounds__",
                 "__restrict__", "__shared__", "__align__", "constexpr",
                 "<<<", "#pragma", 'extern "C"'):
        assert gone not in norm, gone
    ext = cuspec.extract("x.cu", src)
    assert {"k", "entry_launch"} <= set(ext.symbols)


# ---------------------------------------------------------------------------
# SIM204 for C++ and SIM000 for a CUDA file that does not parse

_MAP = {"drop-rng": ["kernel:shadow_tpu_torch/ops/csrc/k.cu:k"]}


def _twin_cu(body):
    text = "__global__ void k(const int64_t* deliver_ns) {\n" + body + "}\n"
    return simtwin.twin_sources({"shadow_tpu_torch/ops/csrc/k.cu": text},
                                simlint.Config(), parse_map(_MAP))


@pytest.mark.parametrize("body", [
    "  int32_t d = (int32_t)deliver_ns[0];\n",
    "  const unsigned lo = static_cast<unsigned>(deliver_ns[0]);\n",
    "  int t = __ll2int_rn(deliver_ns[1] + 1);\n",
    "  uint32_t w = deliver_ns[0] >> 1;\n",
    "  __shared__ int32_t ring[32];\n  ring[0] = deliver_ns[0];\n",
], ids=["c-cast", "static-cast", "intrinsic", "declaration",
        "shared-store"])
def test_sim204_fires_on_cpp_narrowing_of_a_time(body):
    assert _rules_of(_twin_cu(body)) == ["SIM204"]


def test_sim204_quiet_on_counts_and_wide_lanes():
    out = _twin_cu("  int32_t n = (int32_t)count;\n"
                   "  int64_t t = (int64_t)deliver_ns[0];\n"
                   "  __shared__ int64_t s[8];\n  s[0] = deliver_ns[0];\n")
    assert out == []


def test_sim204_cpp_pragma_suppresses_and_a_stale_one_is_sim000():
    out = _twin_cu("  // simtwin: disable=SIM204 -- bounded below 2^31 "
                   "by the caller\n  int32_t d = (int32_t)deliver_ns[0];\n")
    assert _rules_of(out) == [] and {f.rule for f in out} == {"SIM204"}
    stale = _twin_cu("  // simtwin: disable=SIM204 -- nothing here\n"
                     "  int64_t d = deliver_ns[0];\n")
    assert _rules_of(stale) == ["SIM000"]


def test_cuda_file_that_does_not_parse_is_sim000():
    out = _twin_cu("  if (deliver_ns[0] > 0) {\n")
    bad = [f for f in out if f.rule == "SIM000"]
    assert len(bad) == 1 and "does not parse" in bad[0].message
    # and the file's mapped symbol is then missing, not silently found
    assert _rules_of(out) == ["SIM000", "SIM203"]


# ---------------------------------------------------------------------------
# parity with the JAX package on its own tree


def _jax_tree(dst):
    """A copy of what the JAX package's simtwin reads."""
    shutil.copytree(os.path.join(REPO, "shadow_tpu"), dst / "shadow_tpu",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    shutil.copytree(os.path.join(REPO, "native"), dst / "native",
                    ignore=shutil.ignore_patterns("*.so", "*.o", "build"))
    shutil.copytree(os.path.join(REPO, "spec"), dst / "spec")
    shutil.copy(os.path.join(REPO, "pyproject.toml"), dst / "pyproject.toml")


def _edit(path, old, new):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert old in text, (path, old)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text.replace(old, new, 1))


def _both_simtwin(root):
    paths = [str(root / "shadow_tpu"), str(root / "native")]
    ref_cfg = jax_simtwin.load_config(str(root / "pyproject.toml"))
    ref = jax_simtwin.twin_paths(paths, ref_cfg,
                                 jax_simtwin.load_map(None, ref_cfg))
    cfg = simlint.load_config(str(root / "pyproject.toml"), port=False)
    port = simtwin.twin_paths(paths, cfg, simtwin.load_map(None, cfg))
    return port.to_json(), ref.to_json()


def test_simtwin_parity_on_the_jax_tree():
    paths = [os.path.join(REPO, "shadow_tpu"), os.path.join(REPO, "native")]
    ref_cfg = jax_simtwin.load_config(os.path.join(REPO, "pyproject.toml"))
    ref = jax_simtwin.twin_paths(paths, ref_cfg,
                                 jax_simtwin.load_map(None, ref_cfg))
    cfg = simlint.load_config(os.path.join(REPO, "pyproject.toml"),
                              port=False)
    port = simtwin.twin_paths(paths, cfg, simtwin.load_map(None, cfg))
    assert port.to_json() == ref.to_json()
    assert ref.files > 10 and ref.to_json()["summary"]["findings"] == 0


def test_simtwin_parity_on_a_drifted_jax_tree(tmp_path):
    _jax_tree(tmp_path)
    _edit(tmp_path / "shadow_tpu/ops/bandwidth.py",
          "REFILL_NS = 1000000", "REFILL_NS = 1000001")
    _edit(tmp_path / "shadow_tpu/core/rng.py",
          "def threefry2x32_jnp(", "def threefry2x32_jnp_renamed(")
    port, ref = _both_simtwin(tmp_path)
    assert port == ref
    rules = {f["rule"] for f in ref["findings"]}
    assert {"SIM201", "SIM203", "SIM205"} <= rules


# ---------------------------------------------------------------------------
# the port's own planes


@pytest.fixture(scope="module")
def port_twin():
    cfg = simlint.load_config(os.path.join(REPO, "pyproject.toml"))
    surface_map = simtwin.load_map(None, cfg)
    result = simtwin.twin_paths([os.path.join(REPO, "shadow_tpu_torch"),
                                 os.path.join(REPO, "native")], cfg,
                                surface_map)
    sources = simtwin._load_mapped_sources(cfg, surface_map)
    return result, TwinModel(sources, surface_map)


def test_simtwin_finds_nothing_in_the_port(port_twin):
    result, twin = port_twin
    report = result.to_json()
    assert report["findings"] == [], report["findings"]
    # saturate.cu's two designed 32-bit stores carry used pragmas (a stale
    # one would be a SIM000 finding above)
    assert report["summary"]["suppressed"] >= 2
    assert all(f["rule"] == "SIM204" for f in report["suppressed"])


def test_kernel_plane_reads_all_cuda_sources(port_twin):
    _result, twin = port_twin
    cuda = sorted(p for p in twin.cuda_paths)
    assert cuda == sorted(f"{CSRC}/{n}" for n in CUDA_EXPECT)
    assert all(twin.plane_of(p) == "kernel" for p in cuda)


@pytest.mark.parametrize("canon,cuda_files", [
    ("REFILL_INTERVAL_NS", {"admit_sorted.cu"}),
    ("THREEFRY_PARITY", {"threefry.cuh"}),
    ("THREEFRY_ROTATIONS", {"threefry.cuh"}),
    ("HDR_TCP", {"pack_flush.cu", "span_tile.cuh", "torcells_run.cu"}),
    ("CELL_WIRE_BYTES", {"pack_flush.cu", "span_tile.cuh",
                         "torcells_run.cu"}),
])
def test_constants_compared_across_the_planes(port_twin, canon, cuda_files):
    _result, twin = port_twin
    sites = twin.constants_by_canonical()[canon]
    planes = {twin.plane_of(p) for p, _v, _l, _a in sites}
    got = {os.path.basename(p) for p, _v, _l, _a in sites
           if p.startswith(CSRC)}
    assert got == cuda_files
    assert len({repr(v) for _p, v, _l, _a in sites}) == 1
    if canon != "CELL_WIRE_BYTES":       # the payload is the kernels' own
        assert {"python", "c", "kernel"} <= planes, planes


def test_port_settings_rename_and_extend_the_repository_map(port_twin):
    _result, twin = port_twin
    entries = {f"{e.plane}:{e.path}:{e.symbol}"
               for es in twin.map.values() for e in es}
    assert "py:shadow_tpu_torch/core/rng.py:threefry2x32_torch" in entries
    assert not any(e.startswith("py:shadow_tpu/") for e in entries)
    assert not any("threefry2x32_jnp" in e for e in entries)
    assert "kernel:shadow_tpu_torch/ops/csrc/threefry.cuh:" \
        "threefry2x32_x0" in entries


def test_emit_spec_holds_the_cuda_plane_and_defaults_into_the_port(
        tmp_path, capsys):
    out = tmp_path / "protocol.json"
    assert simtwin.main(["--emit-spec", str(out), "--config",
                         os.path.join(REPO, "pyproject.toml")]) == 0
    spec = json.loads(out.read_text())
    assert spec["constants"]["THREEFRY_PARITY"]["kernel"] == {
        "value": 0x1BD11BDA,
        "source": "shadow_tpu_torch/ops/csrc/threefry.cuh#TF_PARITY"}
    assert any(src.endswith(".cu")
               for per in spec["surfaces"].values() for src in per)
    assert simtwin.SPEC_OUT.startswith("shadow_tpu_torch" + os.sep)


# ---------------------------------------------------------------------------
# mutation cases on copies of the port's tree

_KEEP = (".py", ".cu", ".cuh", ".toml", ".json", ".cc", ".h")


def _port_tree(dst):
    """A copy of the port's sources (no build outputs) beside the native
    plane, the spec and the repository's settings."""
    def ignore(d, names):
        return [n for n in names
                if n in ("__pycache__", "build") or (
                    not os.path.isdir(os.path.join(d, n))
                    and not n.endswith(_KEEP))]
    shutil.copytree(os.path.join(REPO, "shadow_tpu_torch"),
                    dst / "shadow_tpu_torch", ignore=ignore)
    os.makedirs(dst / "native")
    for n in ("dataplane.cc", "retransmit_tally.cc"):
        shutil.copy(os.path.join(REPO, "native", n), dst / "native" / n)
    shutil.copytree(os.path.join(REPO, "spec"), dst / "spec")
    shutil.copy(os.path.join(REPO, "pyproject.toml"), dst / "pyproject.toml")


MUTATIONS = {
    "refill-ns-in-admit_sorted.cu": (
        "simtwin", f"{CSRC}/admit_sorted.cu",
        "constexpr int64_t REFILL_NS = 1000000;",
        "constexpr int64_t REFILL_NS = 1000001;", {"SIM201"}),
    "threefry-parity-in-threefry.cuh": (
        "simtwin", f"{CSRC}/threefry.cuh", "0x1BD11BDAu", "0x1BD11BDBu",
        {"SIM201", "SIM205"}),
    "int32-deliver_ns-in-a-cu": (
        "simtwin", f"{CSRC}/packet_hop.cu", "}  // namespace\n",
        "__device__ int32_t probe(int64_t deliver_ns) {\n"
        "  return (int32_t)deliver_ns;\n}\n}  // namespace\n", {"SIM204"}),
    "double-on-an-ns-lane": (
        "simjit", f"{CSRC}/admit_sorted.cu", "}  // namespace\n",
        "__device__ double probe(int64_t arrive_ns) {\n"
        "  return (double)arrive_ns;\n}\n}  // namespace\n", {"SIM303"}),
    "item-on-a-kernel-result-in-the-window": (
        "simjit", "shadow_tpu_torch/parallel/device_plane.py",
        "            pin = self._pinned.acquire((out[9].shape[0],))\n",
        "            t_stop = out[0].item()\n"
        "            pin = self._pinned.acquire((out[9].shape[0],))\n",
        {"SIM302"}),
    "kernel-without-a-budget-bump": (
        "simjit", "shadow_tpu_torch/ops/_build.py",
        '"torcells_run", "mesh_span", "packet_hop_sharded")',
        '"torcells_run", "mesh_span", "packet_hop_sharded", "probe")',
        {"SIM305"}),
    "renamed-threefry2x32_torch": (
        "simtwin", "shadow_tpu_torch/core/rng.py",
        "def threefry2x32_torch(", "def threefry2x32_torch_v2(",
        {"SIM203"}),
    "bandwidth-region-edited-by-hand": (
        "simtwin", "shadow_tpu_torch/ops/bandwidth.py",
        "REFILL_NS = 1000000   # == defs.INTERFACE_REFILL_INTERVAL_NS (1 ms)",
        "REFILL_NS = 1000000   # the interface refill tick",
        {"SIM205"}),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutation_reports_its_rule(case, tmp_path):
    tool, rel, old, new, want = MUTATIONS[case]
    _port_tree(tmp_path)
    _edit(tmp_path / rel, old, new)
    cfg = str(tmp_path / "pyproject.toml")
    if tool == "simtwin":
        config = simlint.load_config(cfg)
        result = simtwin.twin_paths(
            [str(tmp_path / "shadow_tpu_torch"), str(tmp_path / "native")],
            config, simtwin.load_map(None, config))
    else:
        config, budget, kernel, sync = simjit.load_jit_config(cfg)
        target = os.path.dirname(rel) if rel.endswith(".cu") else rel
        paths = [str(tmp_path / target),
                 str(tmp_path / "shadow_tpu_torch/ops")]
        result = simjit.jit_paths(paths, config, budget=budget,
                                  kernel=kernel, sync=sync)
    got = {f.rule for f in result.unsuppressed}
    assert want <= got, (case, [f.render() for f in result.unsuppressed])
    assert all(f.path == rel or f.rule in want
               for f in result.unsuppressed), \
        [f.render() for f in result.unsuppressed]
