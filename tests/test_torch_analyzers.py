"""simlint and simrace over the port: 0 unsuppressed findings.

The repository's analyzer settings (pyproject.toml's ``[tool.simlint]``,
``[tool.simlint.allow]``, ``[tool.simjit]`` and ``[tool.simjit.allow]``)
name the JAX package's paths.  The test writes the same settings into a
scratch directory with every ``shadow_tpu/`` pattern mapped to
``shadow_tpu_torch/``, links the port beside them (the analyzers report
and allowlist paths relative to their config file), and runs each
analyzer's ``main`` over the port: every finding is fixed or carries a
reasoned pragma.  simjit, simtwin and simgen model JAX programs and the
JAX package's protocol tables, so they stay with the JAX package.
"""

import json
import os
import tomllib

import pytest

from shadow_tpu.analysis import simlint, simrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = (("tool", "simlint"), ("tool", "simlint", "allow"),
            ("tool", "simjit"), ("tool", "simjit", "allow"))


def _toml_array(values) -> str:
    return "[" + ", ".join(json.dumps(v) for v in values) + "]"


def port_config(tmp_path) -> str:
    """The analyzer settings re-pointed at the port, and the port linked
    beside them; returns the config's path."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        doc = tomllib.load(f)
    lines = []
    for keys in SECTIONS:
        table = doc
        for k in keys:
            table = table[k]
        lines.append("[" + ".".join(keys) + "]")
        for key, value in table.items():
            if isinstance(value, list):
                value = [v.replace("shadow_tpu/", "shadow_tpu_torch/")
                         for v in value]
                lines.append(f"{key} = {_toml_array(value)}")
        lines.append("")
    cfg = tmp_path / "pyproject.toml"
    cfg.write_text("\n".join(lines))
    os.symlink(os.path.join(REPO, "shadow_tpu_torch"),
               tmp_path / "shadow_tpu_torch")
    return str(cfg)


def test_port_config_maps_every_pattern(tmp_path):
    text = open(port_config(tmp_path)).read()
    assert '"shadow_tpu_torch/obs/*", "shadow_tpu_torch/prof/*"' in text
    assert "shadow_tpu/" not in text


@pytest.mark.parametrize("tool", [simlint, simrace],
                         ids=["simlint", "simrace"])
def test_analyzer_finds_nothing_in_the_port(tool, tmp_path, capsys):
    cfg = port_config(tmp_path)
    rc = tool.main(["--json", "--config", cfg,
                    str(tmp_path / "shadow_tpu_torch")])
    report = json.loads(capsys.readouterr().out)
    assert report["files"] > 100, report["files"]
    assert report["findings"] == [], report["findings"]
    assert rc == 0
    # the pragmas the port carries are still used (a stale one would be
    # a SIM000 finding above)
    assert report["summary"]["suppressed"] > 0
