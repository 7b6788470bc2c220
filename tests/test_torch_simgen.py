"""simgen in the port (shadow_tpu_torch/analysis/simgen.py): the spec's
regions in the port's own files, the CUDA kernel plane's among them.

* parity: every region of the JAX package's emission table renders the
  same body, a hand-edited or stale region gets the same diagnostics, and
  the read-back over the repository (its settings read as written) gives
  the same answer as ``shadow_tpu.analysis.simgen``;
* the port is clean: ``--check`` exits 0 over the port's regions and
  native/'s, and the port's ``ops/bandwidth.py`` carries the
  ``token-bucket-kernel`` region with the JAX package's ``spec=`` and
  ``body=``;
* the CUDA regions: the refill tick's multiply-high reciprocal is computed
  by the generator and meets Granlund and Montgomery's condition, and the
  kernels read the generated constexprs;
* ``--write`` rewrites the port's regions only, never native/'s.
"""

from __future__ import annotations

import os
import random
import re
import shutil

import pytest

from shadow_tpu.analysis import genmark as jax_genmark
from shadow_tpu.analysis import simgen as jax_simgen
from shadow_tpu_torch.analysis import genmark, simgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC, SPEC_HASH = simgen.load_spec(os.path.join(REPO, genmark.SPEC_RELPATH))


def _read(rel):
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        return f.read()


def test_reference_table_is_the_jax_packages():
    assert simgen.REFERENCE_REGIONS == [
        (p, n, lead, getattr(simgen, r.__name__))
        for p, n, lead, r in jax_simgen.REGIONS]
    assert simgen.NATIVE_REGIONS == [
        rd for rd in simgen.REFERENCE_REGIONS if rd[0].startswith("native/")]


@pytest.mark.parametrize("name", sorted({n for _p, n, _l, _r
                                         in jax_simgen.REGIONS}))
def test_region_bodies_render_as_the_jax_package_does(name):
    assert simgen.render_body(name, SPEC) == \
        jax_simgen.render_body(name, SPEC)


def _mutations(text):
    """The file as it is, with one region edited by hand, and with one
    region's spec digest stale."""
    regions, _ = genmark.scan_regions(text)
    reg = regions[0]
    lines = text.splitlines(keepends=True)
    edited = list(lines)
    edited[reg.begin_line] = edited[reg.begin_line].rstrip("\n") + " \n"
    stale = list(lines)
    stale[reg.begin_line - 1] = stale[reg.begin_line - 1].replace(
        f"spec={reg.spec_hash}", "spec=000000000000")
    return [text, "".join(edited), "".join(stale)]


@pytest.mark.parametrize("path", sorted({p for p, _n, _l, _r
                                         in jax_simgen.REGIONS}))
def test_check_text_diagnoses_as_the_jax_package_does(path):
    text = _read(path)
    port_defs = [rd for rd in simgen.REFERENCE_REGIONS if rd[0] == path]
    ref_defs = [rd for rd in jax_simgen.REGIONS if rd[0] == path]
    for variant in _mutations(text):
        port = simgen.check_text(path, variant, port_defs, SPEC, SPEC_HASH)
        ref = jax_simgen.check_text(path, variant, ref_defs, SPEC,
                                    SPEC_HASH)
        assert port == ref
    assert jax_simgen.check_text(path, text, ref_defs, SPEC,
                                 SPEC_HASH) == []


def test_readback_agrees_with_the_jax_package():
    port = simgen.readback_diffs(REPO, SPEC, port=False,
                                 regions=simgen.REFERENCE_REGIONS)
    assert port == jax_simgen.readback_diffs(REPO, SPEC) == []


def test_port_regions_are_current_and_read_back(capsys):
    assert simgen.main(["--check", "--root", REPO]) == 0
    out = capsys.readouterr().out
    n = len(simgen.REGIONS) + len(simgen.NATIVE_REGIONS)
    assert f"0 problem(s), {n} region(s)" in out
    paths = {p for p, _n, _l, _r in simgen.REGIONS}
    assert not any(p.startswith(("shadow_tpu/", "native/")) for p in paths)
    assert {p for p, _n, _l, _r in simgen.NATIVE_REGIONS} == \
        {"native/dataplane.cc"}


def test_port_bandwidth_carries_the_token_bucket_region():
    def region(text):
        regs, problems = genmark.scan_regions(text)
        assert problems == []
        return [r for r in regs if r.name == "token-bucket-kernel"]
    port = region(_read("shadow_tpu_torch/ops/bandwidth.py"))
    ref = region(_read("shadow_tpu/ops/bandwidth.py"))
    assert len(port) == len(ref) == 1
    assert (port[0].spec_hash, port[0].body_hash, port[0].body) == \
        (ref[0].spec_hash, ref[0].body_hash, ref[0].body)
    assert jax_genmark.sha12(port[0].body) == port[0].body_hash


def test_refill_magic_meets_the_division_theorem():
    magic, shift = simgen.refill_magic(1000000)
    assert (magic, shift) == (0x431BDE82D7B634DB, 18)
    assert magic < 1 << 64
    assert 0 <= magic * 1000000 - (1 << (64 + shift)) <= 1 << shift
    rng = random.Random(7)
    xs = [0, 1, 999999, 1000000, 1000001, (1 << 63) - 1, (1 << 64) - 1,
          (1 << 64) - 1000000] + [rng.getrandbits(64) for _ in range(2000)]
    for x in xs:
        assert (x * magic) >> (64 + shift) == x // 1000000, x
    # the smallest shift that holds: one less fails the condition
    m17 = -(-(1 << 81) // 1000000)
    assert m17 * 1000000 - (1 << 81) > 1 << 17


def test_cuda_regions_hold_the_spec_and_the_kernels_read_them():
    c = SPEC["constants"]
    fry = _read("shadow_tpu_torch/ops/csrc/threefry.cuh")
    assert f"TF_PARITY = 0x{c['THREEFRY_PARITY']:X}u" in fry
    assert "TF_PARITY ^ k0 ^ k1" in fry
    assert "TF_ROT[(block & 1) * 4 + j]" in fry
    assert "0x1BD11BDA" not in fry.split("<<< simgen:end")[1]
    admit = _read("shadow_tpu_torch/ops/csrc/admit_sorted.cu")
    assert f"REFILL_NS = {c['REFILL_INTERVAL_NS']};" in admit
    for name in ("pack_flush.cu", "span_tile.cuh", "torcells_run.cu"):
        text = _read(f"shadow_tpu_torch/ops/csrc/{name}")
        assert f"constexpr int64_t HDR_TCP = {c['HDR_TCP']};" in text
        assert re.search(r"CELL_WIRE_BYTES = 512 \+ HDR_TCP;", text), name


def test_write_rewrites_the_port_regions_only(tmp_path):
    for rel in sorted({p for p, _n, _l, _r in simgen.REGIONS
                       + simgen.NATIVE_REGIONS}):
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), tmp_path / rel)
    stale_port = "shadow_tpu_torch/ops/csrc/admit_sorted.cu"
    stale_native = "native/dataplane.cc"
    for rel in (stale_port, stale_native):
        text = (tmp_path / rel).read_text()
        (tmp_path / rel).write_text(re.sub(r"spec=[0-9a-f]{12}",
                                           "spec=000000000000", text,
                                           count=1))
    native_before = (tmp_path / stale_native).read_text()
    written, problems = simgen.write_tree(str(tmp_path), SPEC, SPEC_HASH)
    assert problems == []
    assert written == [f"{stale_port}:cuda-refill"]
    assert (tmp_path / stale_port).read_text() == _read(stale_port)
    assert (tmp_path / stale_native).read_text() == native_before
    diags = simgen.check_tree(str(tmp_path), SPEC, SPEC_HASH,
                              readback=False)
    assert len(diags) == 1 and diags[0].startswith(stale_native)
