"""The port's log tools (``tools/trace_report.py``, ``parse_log.py``,
``plot_log.py``: copies of the JAX package's) over the port's own output.

A small device-traffic run of the port on the CPU, with a cost model
loaded, writes a Chrome trace (``--trace``), a metrics stream
(``--metrics``) and its log: ``trace_report`` folds the trace (its
``device.window`` spans on the ``device-sim`` track) and the metrics (the
``prof.*`` histograms' percentiles), ``parse_log`` the log, each as the
JAX package's copy of the tool folds the same files.  ``--trend`` renders
a history written by the port's ledger (regression flags, the CLI's exit
codes), as the JAX package's renders it.
"""

import io
import json
import os

import pytest

from shadow_tpu.tools import parse_log as jparse_log
from shadow_tpu.tools import plot_log as jplot_log
from shadow_tpu.tools import trace_report as jtrace_report
from shadow_tpu_torch.core import configuration
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.core.logger import SimLogger, set_logger
from shadow_tpu_torch.core.options import Options
from shadow_tpu_torch.obs.metrics import read_metrics_file
from shadow_tpu_torch.prof import ledger
from shadow_tpu_torch.prof import model as prof_model
from shadow_tpu_torch.tools import parse_log, plot_log, trace_report
from shadow_tpu_torch.tools import workloads

STAR_XML = workloads.star_bulk(6, stoptime=60, bulk_bytes=4 * 1024 * 1024,
                               device_data=True)


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """One port run on the CPU with a model, a trace, metrics and a log."""
    d = tmp_path_factory.mktemp("log-tools")
    cm = str(d / "cm.json")
    prof_model.save_model(cm, prof_model.build_model({
        "collectives": {"psum": {"2x2": 1.0}},
        "step_kernel": {"points": [{"flows": 1, "us_per_step": 5.0},
                                   {"flows": 1000, "us_per_step": 50.0}]},
        "transfer": {"dispatch_us": 10.0, "flush_us": 10.0}},
        fingerprint=prof_model.box_fingerprint("cpu")))
    paths = {"trace": str(d / "trace.json"), "metrics": str(d / "m.jsonl"),
             "log": str(d / "run.log")}
    cfg = configuration.parse_xml(STAR_XML)
    stream = io.StringIO()
    log = SimLogger(stream=stream, level="message")
    set_logger(log)
    ctrl = Controller(Options(
        scheduler_policy="global", workers=0, seed=3, stop_time_sec=60,
        log_level="message", device="cpu", device_plane_granule_ms=4,
        cost_model=cm, trace_path=paths["trace"],
        metrics_path=paths["metrics"], metrics_every_rounds=50), cfg)
    assert ctrl.run() == 0
    log.flush()
    with open(paths["log"], "w") as f:
        f.write(stream.getvalue())
    assert ctrl.engine.metrics.scrape()["prof.launches_checked"] > 0
    return paths


def test_trace_report_folds_the_ports_trace(run_files, capsys):
    events = trace_report.load_events(run_files["trace"])
    wins = [e for e in events if e["name"] == "device.window"]
    assert wins, "no device.window spans in the port's trace"
    assert all(e["tid"] == "device-sim" for e in wins)
    for e in wins:
        assert e["args"]["sim_ns"] >= 0
        assert e["args"]["measured_us"] > 0
        assert e["args"]["exchange_mode"] == "single"
    rep = trace_report.summarize(events)
    assert any(t.endswith(":device-sim") for t in rep["tracks"])
    assert rep == jtrace_report.summarize(
        jtrace_report.load_events(run_files["trace"]))
    assert trace_report.main([run_files["trace"]]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(rep, sort_keys=True))


def test_trace_report_folds_the_ports_metrics(run_files, capsys):
    records = read_metrics_file(run_files["metrics"])
    rep = trace_report.summarize_metrics(records)
    hist = rep["histograms"]["prof.launch_predicted_us"]
    assert hist["count"] > 0 and "p99" in hist
    assert rep["final"]["prof.autotune_source"] == "model"
    assert rep == jtrace_report.summarize_metrics(records)
    assert trace_report.main(["--metrics", run_files["metrics"]]) == 0
    assert json.loads(capsys.readouterr().out)["histograms"]
    assert trace_report.main(["--compare", run_files["metrics"],
                              run_files["metrics"]]) == 0


def test_parse_log_reads_the_ports_log(run_files, tmp_path):
    with open(run_files["log"]) as f:
        lines = f.readlines()
    assert lines
    got = parse_log.parse_log(lines)
    assert got == jparse_log.parse_log(lines)
    assert list(parse_log.strip_log(lines)) == \
        list(jparse_log.strip_log(lines))
    assert parse_log.main(["parse", run_files["log"]]) == 0
    beats = plot_log.engine_heartbeats(lines)
    assert beats and beats == jplot_log.engine_heartbeats(lines)


def test_trend_renders_the_ports_ledger(tmp_path, capsys):
    lp = str(tmp_path / "hist.jsonl")
    ledger.append_row(lp, "tor10k", {"wall_sec": 10.0,
                                     "sim_sec_per_wall_sec": 2.0,
                                     "plane": {"dispatches": 40},
                                     "scenario": "tor10k"})
    ledger.append_row(lp, "tor10k", {"wall_sec": 9.0,
                                     "sim_sec_per_wall_sec": 2.4})
    ledger.append_row(lp, "tor10k", {"wall_sec": 14.0,
                                     "sim_sec_per_wall_sec": 1.5})
    ledger.append_row(lp, "mesh10k", {"host_bounces": 0})
    recs = ledger.load_history(lp)
    assert len(recs) == 4
    assert all(r["box"] and r["sha"] and r["ts"] for r in recs)
    assert recs[0]["cols"]["plane.dispatches"] == 40
    rep = trace_report.summarize_trend(recs)
    cols = rep["rows"]["tor10k"]["columns"]
    assert cols["wall_sec"]["regressed"] is True
    assert cols["sim_sec_per_wall_sec"]["regressed"] is True
    assert "tor10k:wall_sec" in rep["regressions"]
    assert rep["rows"]["mesh10k"]["columns"]["host_bounces"][
        "regressed"] is None
    assert rep == jtrace_report.summarize_trend(recs)
    assert trace_report.main(["--trend", lp]) == 0
    assert json.loads(capsys.readouterr().out)["regressions"]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert trace_report.main(["--trend", str(empty)]) == 1
    assert os.path.basename(ledger.default_history_path()) == \
        "BENCH_HISTORY_TORCH.jsonl"
