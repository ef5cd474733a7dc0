"""The port's run manifests and its obs CLIs (`repro_torch.obs.manifest`,
``python -m repro_torch.obs.{monitor,perfetto,report}``) over run
directories the port writes, and ``sweep --mode grid --metrics / --trace /
--profile`` on the CPU, against the reference (`repro.obs`).

Everything here is host text and JSON, so the comparisons are exact: the
manifest's keys and config digest are the reference's (its environment
names this stack), the CLIs' outputs equal the reference CLIs' on the same
inputs, and each package reads the other's files.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.obs import monitor as jmonitor
from repro.obs import perfetto as jperfetto
from repro.obs import read_events as jread_events
from repro.obs import read_manifest as jread_manifest
from repro.obs import report as jreport
from repro.obs import write_manifest as jwrite_manifest
from repro.obs.metrics import read_metrics as jread_metrics
from repro_torch import prng
from repro_torch.core import BridgeConfig, BridgeTrainer, erdos_renyi, replicate
from repro_torch.launch import sweep
from repro_torch.obs import (AlertRules, EventLog, MetricSpec, MetricWriter, read_events,
                             read_manifest, read_metrics, write_manifest)
from repro_torch.obs import monitor, perfetto, report
from repro_torch.obs.monitor import RunTail
from repro_torch.sim.results import cell_of

M, D, T = 10, 4, 12


def _write_jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def qgrad(params, batch):
    w = params["w"]
    return 0.5 * torch.sum((w - batch) ** 2, dim=-1), {"w": w - batch}


@pytest.fixture()
def port_run(tmp_path):
    """A run directory the port wrote: the start manifest, then
    `run_chunks` with a metric writer (alerts on) and an event log; the
    last two ticks diverge (a NaN target), then the end manifest."""
    d = str(tmp_path / "run")
    write_manifest(d, kind="train", config={"steps": T, "rule": "trimmed_mean"})
    tr = BridgeTrainer(BridgeConfig(topology=erdos_renyi(M, 0.8, 2, seed=1), num_byzantine=2,
                                    attack="alie", t0=10.0, metrics=MetricSpec(capacity=4)),
                       qgrad, device="cpu")
    tg = torch.tensor(np.random.default_rng(0).normal(size=(M, D)), dtype=torch.float32)
    bad = torch.full((M, D), float("nan"))
    st = tr.init(replicate({"w": torch.zeros(D)}, M, perturb=0.1, key=prng.PRNGKey(0)))
    with EventLog(os.path.join(d, "events.jsonl")) as ev, \
            MetricWriter(os.path.join(d, "metrics.jsonl"), alerts=AlertRules(), events=ev) as w:
        tr.run_chunks(st, lambda i: bad if i >= T - 2 else tg, T, writer=w, events=ev)
    write_manifest(d, extra={"ended": True, "wall_s": 1.5})
    return d


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------


def test_manifest_round_trip_merge_and_the_reference_schema(tmp_path):
    d, jd = str(tmp_path / "p"), str(tmp_path / "j")
    cfg = {"lr": 0.1, "steps": 8, "rules": ["median", "trimmed_mean"]}
    write_manifest(d, kind="train", config=cfg)
    jwrite_manifest(jd, kind="train", config=cfg)
    m, jm = read_manifest(d), jread_manifest(jd)
    assert set(m) == set(jm) and m["config"] == jm["config"] == cfg
    assert m["config_digest"] == jm["config_digest"] and len(m["config_digest"]) == 16
    env = m["environment"]
    assert {"python", "platform", "torch", "cuda", "backend", "device_kind", "device_count",
            "power_limit"} <= set(env) and "jax" not in env
    assert env["torch"] == torch.__version__
    assert env["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    write_manifest(d, extra={"ended": True, "wall_s": 3.5})
    m2 = jread_manifest(d)  # the reference reads the port's manifest
    assert m2["kind"] == "train" and m2["config_digest"] == m["config_digest"]
    assert m2["ended"] is True and m2["wall_s"] == 3.5
    assert os.listdir(d) == ["manifest.json"]
    write_manifest(str(tmp_path / "q"), config={"steps": 8, "lr": 0.1,
                                                 "rules": ["median", "trimmed_mean"]})
    assert read_manifest(str(tmp_path / "q"))["config_digest"] == m["config_digest"]
    assert read_manifest(str(tmp_path / "none")) is None
    with open(tmp_path / "q" / "manifest.json", "w") as f:
        f.write('{"kind": "tr')
    assert read_manifest(str(tmp_path / "q")) is None


# ---------------------------------------------------------------------------
# the CLIs over a run the port wrote
# ---------------------------------------------------------------------------


def test_port_run_files_and_monitor_once(port_run, capsys):
    rows = read_metrics(os.path.join(port_run, "metrics.jsonl"))
    assert [r["tick"] for r in rows] == list(range(T))
    assert rows == jread_metrics(os.path.join(port_run, "metrics.jsonl"))
    events = read_events(os.path.join(port_run, "events.jsonl"))
    assert [e["tag"] for e in events].count("train.chunk") == 3
    alerts = [e for e in events if e["tag"] == "obs.alert"]
    assert [(a["kind"], a["tick"]) for a in alerts] == [("divergence", T - 2)]
    assert monitor.main([port_run, "--once"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert jmonitor.main([port_run, "--once"]) == 0
    jsnap = json.loads(capsys.readouterr().out)
    assert snap == jsnap
    assert snap["rows"] == T and snap["tags"] == ["train"] and snap["last"]["tick"] == T - 1
    assert [a["kind"] for a in snap["alerts"]] == ["divergence"]
    assert snap["manifest"]["ended"] is True


def test_runtail_incremental_and_torn_line(port_run):
    tail = RunTail(port_run)
    tail.refresh()
    assert len(tail.rows) == T
    mpath = os.path.join(port_run, "metrics.jsonl")
    with open(mpath, "a") as f:
        f.write('{"tag": "train", "wall": 9.0, "tick": 99, "lo')
    tail.refresh()
    assert len(tail.rows) == T
    with open(mpath, "a") as f:
        f.write('ss": 1.0}\n')
    tail.refresh()
    assert len(tail.rows) == T + 1 and tail.rows[-1]["loss"] == 1.0
    assert tail.metrics_since(T - 2, "train")[0]["tick"] == T - 1


def test_perfetto_export_equals_the_reference(port_run, tmp_path, capsys):
    path = perfetto.export(port_run)
    assert path == os.path.join(port_run, "trace.json")
    with open(path) as f:
        trace = json.load(f)
    jpath = jperfetto.export(port_run, str(tmp_path / "j.json"))
    with open(jpath) as f:
        assert json.load(f) == trace
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"train.chunk", "train/loss", "train/grad_norm", "obs.alert"} <= names
    assert trace["otherData"]["kind"] == "train"
    assert perfetto.main([port_run, "--out", str(tmp_path / "t.json")]) == 0
    assert "trace events" in capsys.readouterr().out


def test_report_renders_a_port_run(port_run, capsys):
    text = report.render(None, read_events(os.path.join(port_run, "events.jsonl")),
                         manifest=read_manifest(port_run),
                         metrics_rows=read_metrics(os.path.join(port_run, "metrics.jsonl")))
    assert "kind: train" in text and f"torch {torch.__version__}" in text
    assert "live metric streams" in text and "train" in text


SUMMARY = [{"tag": "a", "rule": "median", "first_bad_tick": None,
            "survival": {"byz_trim_freq": 0.8, "honest_trim_freq": 0.1},
            "auc_byzantine_edges": 0.95,
            "top_edges": [{"trim_freq": 0.8, "receiver": 1, "sender": 2, "seen": 10,
                           "byzantine": True}]}]
EVENTS = [{"tag": "grid.chunk", "wall_s": 0.5}, {"tag": "run.end"},
          {"tag": "obs.divergence", "cell": "c0", "first_bad_tick": 3}]


@pytest.mark.parametrize("summary,events,want", [
    (SUMMARY, None, "all traced cells stayed finite"),
    (None, EVENTS, "divergence events"),
    ([], None, "cells traced: 0"),
    ([{"first_bad_tick": 4}, {"tag": "b"}], None, "cell0"),
])
def test_report_cli_matches_the_reference(tmp_path, capsys, summary, events, want):
    if summary is not None:
        with open(tmp_path / "obs_summary.json", "w") as f:
            json.dump({"meta": {"kind": "test"}, "cells": summary}, f)
    if events is not None:
        _write_jsonl(tmp_path / "events.jsonl", events)
    report.main([str(tmp_path)])
    out = capsys.readouterr().out
    jreport.main([str(tmp_path)])
    assert out == capsys.readouterr().out and want in out
    report.main([str(tmp_path), "--out", str(tmp_path / "r.txt")])
    assert (tmp_path / "r.txt").read_text() == capsys.readouterr().out


def test_report_empty_run_dir_exits_with_message(tmp_path):
    with pytest.raises(SystemExit, match="no obs_summary.json"):
        report.main([str(tmp_path)])


def test_chrome_trace_golden_matches_the_reference():
    events = [{"tag": "run.start", "wall": 0.0, "time": 1.0, "steps": 4},
              {"tag": "train.chunk", "wall": 0.5, "time": 1.5, "train_tag": "train", "lo": 0,
               "hi": 2, "dispatch_s": 0.4},
              {"tag": "obs.alert", "wall": 0.6, "time": 1.6, "kind": "divergence",
               "stream": "train", "tick": 2}]
    rows = [{"tag": "train", "wall": 0.45, "tick": 1, "loss": 1.5, "stale_p50": None}]
    got = perfetto.chrome_trace(events, rows, {"kind": "unit-test"})
    assert got == jperfetto.chrome_trace(events, rows, {"kind": "unit-test"})
    x = next(e for e in got["traceEvents"] if e["ph"] == "X")
    assert x["ts"] == pytest.approx(0.1 * 1e6) and x["dur"] == pytest.approx(0.4 * 1e6)


# ---------------------------------------------------------------------------
# sweep --mode grid with the observability flags
# ---------------------------------------------------------------------------


def test_sweep_grid_metrics_trace_profile(tmp_path):
    out, run, prof = (str(tmp_path / x) for x in ("out", "run", "prof"))
    base = ["--mode", "grid", "--device", "cpu", "--rules", "trimmed_mean,median", "--attacks",
            "alie", "--grid-nodes", "10", "--grid-ticks", "4", "--grid-train", "300",
            "--grid-test", "50"]
    res = sweep.main(base + ["--out", out, "--metrics", run, "--metrics-capacity", "8",
                             "--trace", run, "--profile", prof, "--grid-chunk", "1"])
    tags = [cell_of(c).tag for c in res.cells]
    rows = read_metrics(os.path.join(run, "metrics.jsonl"))
    assert sorted({r["tag"] for r in rows}) == sorted(tags)
    assert all([r["tick"] for r in rows if r["tag"] == t] == [0, 1, 2, 3] for t in tags)
    with open(os.path.join(run, "obs_summary.json")) as f:
        summary = json.load(f)
    assert [c["tag"] for c in summary["cells"]] == tags
    assert all(0.0 <= c["auc_byzantine_edges"] <= 1.0 for c in summary["cells"])
    man = jread_manifest(run)
    assert man["kind"] == "sweep-grid" and man["ended"] is True and man["cells"] == 2
    ev = [e["tag"] for e in jread_events(os.path.join(run, "events.jsonl"))]
    assert ev[0] == "run.start" and "run.end" in ev and "profile.capture" in ev
    assert ev.count("grid.chunk") == 2
    with open(os.path.join(prof, "profile.trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"bridge.screen", "bridge.metrics", "bridge.obs"} <= names
    # metrics and trace on are bit-inert: the same sweep without them
    plain = sweep.main(base + ["--out", str(tmp_path / "plain"), "--grid-chunk", "1"])
    for a, b in zip(res.cells, plain.cells, strict=True):
        assert a["final_loss"] == b["final_loss"] and a["accuracy"] == b["accuracy"]
    assert "mean_grad_norm" in res.cells[0]
    assert jmonitor.main([run, "--once"]) == 0
