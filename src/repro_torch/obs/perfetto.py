"""Perfetto / Chrome-trace export: one ``trace.json`` per run directory — a
copy of `repro.obs.perfetto` (plain Python) with its imports pointing at
`repro_torch.obs`.

``chrome.tracing`` and https://ui.perfetto.dev render the Trace Event
Format — a flat list of timestamped events.  This module converts the run
artifacts the obs layer already writes (``events.jsonl`` host-side event
records, ``metrics.jsonl`` per-tick scalar rows, ``manifest.json``) into
that format, so a whole run — chunk dispatches, grid compilation chunks,
alerts, divergences, and every metric stream as a counter track — lands on
one zoomable timeline:

* events carrying a duration (``wall_s`` from blocking grid chunks and run
  brackets, ``dispatch_s`` from non-blocking ``train.chunk`` dispatches)
  become complete ("X") slices ending at their record's wall time;
* all other events become instants ("i") on their source track;
* metric rows become counter ("C") tracks named ``<tag>/<column>``;
* the manifest rides in ``otherData`` (what run is this, exactly?).

Timestamps are each record's ``wall`` field (seconds since its log opened)
scaled to microseconds.  The event log and metric writer are opened at the
same run bracket, so their clocks agree to within process-startup noise —
good enough for a timeline whose slices are milliseconds wide.

CLI: ``python -m repro_torch.obs.perfetto RUN_DIR [--out trace.json]``.
"""
from __future__ import annotations

import argparse
import json
import os
from collections.abc import Iterable
from typing import Any

# event tags -> the field holding their duration in seconds (everything
# else renders as an instant)
_DURATION_FIELDS = ("wall_s", "dispatch_s")
# record fields that are identity/timing, not interesting args
_META_FIELDS = {"tag", "wall", "time"}

_PID = 1


def _track_of(rec: dict) -> str:
    """The thread-track an event record belongs to."""
    tag = rec.get("tag", "event")
    if tag == "train.chunk":
        # run_chunks events carry the metric stream's tag as `train_tag`
        # (the record's own "tag" field is the event name)
        return f"train/{rec.get('train_tag', 'train')}"
    if tag.startswith("grid."):
        return "grid"
    if tag.startswith("breakdown."):
        return "breakdown"
    if tag.startswith("obs.") or tag.startswith("profile."):
        return "alerts" if tag == "obs.alert" else "obs"
    return "run"


def _event_entries(events: Iterable[dict], tids: dict) -> list[dict]:
    out = []
    for rec in events:
        tag = rec.get("tag", "event")
        wall = float(rec.get("wall", 0.0))
        track = _track_of(rec)
        tid = tids.setdefault(track, len(tids) + 1)
        args = {k: v for k, v in rec.items() if k not in _META_FIELDS}
        dur = None
        for f in _DURATION_FIELDS:
            if f in rec:
                try:
                    dur = float(rec[f])
                except (TypeError, ValueError):
                    dur = None
                break
        if dur is not None and dur >= 0.0:
            out.append({
                "name": tag, "ph": "X", "pid": _PID, "tid": tid,
                "ts": (wall - dur) * 1e6, "dur": dur * 1e6, "args": args,
            })
        else:
            out.append({
                "name": tag, "ph": "i", "s": "t", "pid": _PID, "tid": tid,
                "ts": wall * 1e6, "args": args,
            })
    return out


def _counter_entries(rows: Iterable[dict]) -> list[dict]:
    out = []
    for rec in rows:
        tag = rec.get("tag", "train")
        wall = float(rec.get("wall", 0.0))
        for col, v in rec.items():
            if col in _META_FIELDS or col == "tick" or v is None:
                continue
            if not isinstance(v, (int, float)):
                continue
            out.append({
                "name": f"{tag}/{col}", "ph": "C", "pid": _PID, "tid": 0,
                "ts": wall * 1e6, "args": {col: v},
            })
    return out


def chrome_trace(events: Iterable[dict] | None = None,
                 metrics_rows: Iterable[dict] | None = None,
                 manifest: dict | None = None) -> dict:
    """Assemble a Trace Event Format dict from parsed run artifacts."""
    tids: dict[str, int] = {}
    trace_events: list[dict] = []
    if events:
        trace_events.extend(_event_entries(events, tids))
    if metrics_rows:
        trace_events.extend(_counter_entries(metrics_rows))
    # metadata: name the process and each thread track
    meta: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": "repro"},
    }]
    for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
            "args": {"name": track},
        })
    trace: dict[str, Any] = {
        "traceEvents": meta + sorted(trace_events, key=lambda e: e["ts"]),
        "displayTimeUnit": "ms",
    }
    if manifest:
        trace["otherData"] = manifest
    return trace


def export(run_dir: str, out: str | None = None) -> str:
    """Convert a run directory's artifacts into ``trace.json`` (returns the
    written path).  Missing inputs are skipped — a killed run with only a
    partial ``metrics.jsonl`` still renders."""
    from repro_torch.obs.events import read_events
    from repro_torch.obs.manifest import read_manifest
    from repro_torch.obs.metrics import read_metrics

    events_path = os.path.join(run_dir, "events.jsonl")
    events = read_events(events_path) if os.path.exists(events_path) else []
    rows = read_metrics(os.path.join(run_dir, "metrics.jsonl"))
    trace = chrome_trace(events, rows, read_manifest(run_dir))
    out = out or os.path.join(run_dir, "trace.json")
    with open(out, "w") as f:
        json.dump(trace, f)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Export a run directory's events/metrics/manifest as a "
                    "Perfetto/chrome-tracing trace.json")
    p.add_argument("run_dir", help="directory holding events.jsonl / metrics.jsonl")
    p.add_argument("--out", default=None, help="output path (default RUN_DIR/trace.json)")
    args = p.parse_args(argv)
    path = export(args.run_dir, args.out)
    with open(path) as f:
        n = len(json.load(f).get("traceEvents", []))
    print(f"wrote {path} ({n} trace events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
