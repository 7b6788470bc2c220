"""simlint and simrace of the port (shadow_tpu_torch/analysis/) over the
port: 0 unsuppressed findings; and over the JAX package: its own findings.

The repository's analyzer settings (pyproject.toml's ``[tool.simlint]``,
``[tool.simlint.allow]``, ``[tool.simjit*]`` and ``[tool.simtwin.map]``)
name the JAX package's paths.  The port's ``simlint.load_config`` reads
them with every ``shadow_tpu/`` turned into ``shadow_tpu_torch/`` and the
port's ``analysis/port.toml`` merged over them (analysis/settings.py), so
the port's tools run over the port from the repository's root with no
settings of their own to copy.  simtwin, simgen and simjit of the port have
their own test files (test_torch_simtwin.py, test_torch_simgen.py,
test_torch_simjit.py).
"""

import json
import os

import pytest

from shadow_tpu.analysis import simlint as jax_simlint
from shadow_tpu.analysis import simrace as jax_simrace
from shadow_tpu_torch.analysis import simlint, simrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYPROJECT = os.path.join(REPO, "pyproject.toml")


def test_port_config_maps_every_pattern():
    config = simlint.load_config(PYPROJECT)
    text = config.text
    assert '"shadow_tpu_torch/obs/*", "shadow_tpu_torch/prof/*"' in text
    assert "shadow_tpu/" not in text
    assert config.allow["SIM001"] == ["shadow_tpu_torch/obs/*",
                                      "shadow_tpu_torch/prof/*"]
    # read as written, the settings are the JAX package's
    ref = simlint.load_config(PYPROJECT, port=False)
    assert ref.allow == jax_simlint.load_config(PYPROJECT).allow
    assert ref.exclude == jax_simlint.load_config(PYPROJECT).exclude


@pytest.mark.parametrize("tool", [simlint, simrace],
                         ids=["simlint", "simrace"])
def test_analyzer_finds_nothing_in_the_port(tool, capsys):
    rc = tool.main(["--json", os.path.join(REPO, "shadow_tpu_torch")])
    report = json.loads(capsys.readouterr().out)
    assert report["files"] > 100, report["files"]
    assert report["findings"] == [], report["findings"]
    assert rc == 0
    # the pragmas the port carries are still used (a stale one would be
    # a SIM000 finding above)
    assert report["summary"]["suppressed"] > 0


@pytest.mark.parametrize("port,ref", [
    (simlint.lint_paths, jax_simlint.lint_paths),
    (simrace.race_paths, jax_simrace.race_paths)],
    ids=["simlint", "simrace"])
def test_analyzer_gives_the_jax_packages_findings_on_its_tree(port, ref):
    paths = [os.path.join(REPO, "shadow_tpu")]
    got = port(paths, simlint.load_config(PYPROJECT, port=False))
    want = ref(paths, jax_simlint.load_config(PYPROJECT))
    assert got.to_json() == want.to_json()
    assert want.files > 100 and want.to_json()["summary"]["suppressed"] > 0
