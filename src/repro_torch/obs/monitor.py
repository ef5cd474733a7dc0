"""Live run monitor: ``python -m repro_torch.obs.monitor RUN_DIR`` — a copy
of `repro.obs.monitor` (plain Python) with its imports pointing at
`repro_torch.obs` and the dashboard's header naming the port's stack.

A stdlib-only (http.server) dashboard over the artifacts a running — or
killed — run leaves in its directory: it tails ``metrics.jsonl`` for the
per-tick scalar streams, re-evaluates the same `repro_torch.obs.metrics.AlertEngine`
the writer runs (so alerts fire even for runs that died before emitting
them), and serves a single-file dark HTML dashboard plus three JSON
endpoints:

* ``/``                               — the dashboard
* ``/api/run``                        — manifest, tags, alert list, totals
* ``/api/metrics?after=T&tag=X``      — metric rows (incremental by tick)
* ``/api/events?offset=N``            — event records (incremental by index)

The tailer remembers its file offset, so each poll reads only appended
bytes; a ``metrics.jsonl`` being written concurrently is safe to tail
(truncated final lines are skipped and re-read on the next poll).

``--once`` prints a JSON snapshot and exits — the smoke path and a quick
"is it diverging?" check over ssh without holding a port open.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from repro_torch.obs.manifest import read_manifest
from repro_torch.obs.metrics import AlertEngine, AlertRules


class RunTail:
    """Incremental reader over a run directory's JSONL artifacts.

    ``refresh()`` reads bytes appended since the last call, parses complete
    lines, feeds new metric rows through the alert engine, and leaves a
    partial trailing line in the offset for the next round.
    """

    def __init__(self, run_dir: str, *, rules: AlertRules | None = None,
                 max_rows: int = 200_000):
        self.run_dir = run_dir
        self.metrics_path = os.path.join(run_dir, "metrics.jsonl")
        self.events_path = os.path.join(run_dir, "events.jsonl")
        self.rows: list[dict] = []
        self.events: list[dict] = []
        self.alerts: list[dict] = []
        self._offsets = {self.metrics_path: 0, self.events_path: 0}
        self._engine = AlertEngine(rules)
        self._max_rows = max_rows
        self._lock = threading.Lock()

    def _read_new_lines(self, path: str) -> list[dict]:
        if not os.path.exists(path):
            return []
        out = []
        with open(path, "rb") as f:
            f.seek(self._offsets[path])
            while True:
                pos = f.tell()
                line = f.readline()
                if not line:
                    break
                if not line.endswith(b"\n"):
                    # torn tail of a live writer: re-read it next refresh
                    f.seek(pos)
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
            self._offsets[path] = f.tell()
        return out

    def refresh(self) -> None:
        with self._lock:
            for row in self._read_new_lines(self.metrics_path):
                self.rows.append(row)
                self.alerts.extend(
                    self._engine.feed(row.get("tag", "train"), row))
            if len(self.rows) > self._max_rows:
                self.rows = self.rows[-self._max_rows:]
            for rec in self._read_new_lines(self.events_path):
                self.events.append(rec)
                # alerts the run emitted itself (writer-side engine); its
                # stream tag rides in `stream` (the record's "tag" field is
                # the event name "obs.alert")
                if rec.get("tag") == "obs.alert":
                    key = (rec.get("stream", ""), rec.get("kind", ""))
                    if key not in {(a.get("tag", ""), a.get("kind", ""))
                                   for a in self.alerts}:
                        a = {k: v for k, v in rec.items()
                             if k not in ("wall", "time", "tag")}
                        a["tag"] = rec.get("stream", "")
                        a.pop("stream", None)
                        self.alerts.append(a)

    def tags(self) -> list[str]:
        return sorted({r.get("tag", "train") for r in self.rows})

    def snapshot(self) -> dict:
        self.refresh()
        last = self.rows[-1] if self.rows else None
        return {
            "run_dir": self.run_dir,
            "manifest": read_manifest(self.run_dir),
            "tags": self.tags(),
            "rows": len(self.rows),
            "events": len(self.events),
            "alerts": self.alerts,
            "last": last,
        }

    def metrics_since(self, after: int, tag: str | None) -> list[dict]:
        self.refresh()
        return [r for r in self.rows
                if int(r.get("tick", -1)) > after
                and (tag is None or r.get("tag") == tag)]

    def events_since(self, offset: int) -> tuple[list[dict], int]:
        self.refresh()
        return self.events[offset:], len(self.events)


def _handler_for(tail: RunTail):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200) -> None:
            self._send(json.dumps(obj).encode(), "application/json", code)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            try:
                if url.path == "/":
                    self._send(DASHBOARD_HTML.encode(), "text/html; charset=utf-8")
                elif url.path == "/api/run":
                    self._json(tail.snapshot())
                elif url.path == "/api/metrics":
                    after = int(q.get("after", ["-1"])[0])
                    tag = q.get("tag", [None])[0]
                    self._json({"rows": tail.metrics_since(after, tag)})
                elif url.path == "/api/events":
                    offset = int(q.get("offset", ["0"])[0])
                    events, total = tail.events_since(offset)
                    self._json({"events": events, "total": total})
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # keep the monitor alive over bad input
                self._json({"error": str(e)}, 500)

    return Handler


def serve(run_dir: str, *, host: str = "127.0.0.1", port: int = 8765,
          rules: AlertRules | None = None) -> ThreadingHTTPServer:
    """Build (but do not run) the monitor server — ``serve_forever`` it, or
    drive it from a test thread and ``shutdown()`` when done."""
    tail = RunTail(run_dir, rules=rules)
    tail.refresh()
    server = ThreadingHTTPServer((host, port), _handler_for(tail))
    server.tail = tail  # for tests / callers
    return server


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Live dashboard over a run directory's metrics.jsonl / "
                    "events.jsonl / manifest.json")
    p.add_argument("run_dir")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--once", action="store_true",
                   help="print a JSON snapshot and exit (no server)")
    p.add_argument("--wire-budget-bytes", type=float, default=None,
                   help="alert when a tag's cumulative wire bytes cross this")
    args = p.parse_args(argv)
    rules = AlertRules(wire_budget_bytes=args.wire_budget_bytes)
    if args.once:
        tail = RunTail(args.run_dir, rules=rules)
        # BrokenPipeError: `--once | head` is a legitimate use
        with contextlib.suppress(BrokenPipeError):
            print(json.dumps(tail.snapshot(), indent=2, default=repr))
        return 0
    server = serve(args.run_dir, host=args.host, port=args.port, rules=rules)
    print(f"monitoring {args.run_dir} at http://{args.host}:{server.server_address[1]}/")
    try:
        # ctrl-C is the supported shutdown; fall through to close
        with contextlib.suppress(KeyboardInterrupt):
            server.serve_forever()
    finally:
        server.server_close()
    return 0


# ---------------------------------------------------------------------------
# The dashboard: one dark-mode HTML file, inline vanilla JS + SVG.
#
# Colors are the reference dataviz palette's dark-mode values (first three
# categorical slots — the subset documented to validate all-pairs on the
# dark surface), status colors reserved for the alert feed, chart chrome
# from the same reference (surface #1a1a19, page #0d0d0d, muted ink
# #898781, hairline grid #2c2c2a).  Each chart draws at most three series;
# identity is carried by the legend + direct labels, not color alone.
# ---------------------------------------------------------------------------

DASHBOARD_HTML = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>repro run monitor</title>
<style>
  :root {
    color-scheme: dark;
    --page: #0d0d0d; --surface: #1a1a19;
    --ink: #ffffff; --ink-2: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --axis: #383835;
    --s1: #3987e5; --s2: #d95926; --s3: #199e70;
    --crit: #d03b3b; --warn: #fab219; --good: #0ca30c; --serious: #ec835a;
    --ring: rgba(255,255,255,0.10);
  }
  body { background: var(--page); color: var(--ink-2); margin: 0;
         font: 13px/1.5 system-ui, -apple-system, "Segoe UI", sans-serif; }
  header { padding: 12px 20px; border-bottom: 1px solid var(--ring);
           display: flex; gap: 16px; align-items: baseline; flex-wrap: wrap; }
  header h1 { font-size: 15px; color: var(--ink); margin: 0; font-weight: 600; }
  header .meta { color: var(--muted); font-size: 12px; }
  .filters { padding: 10px 20px; display: flex; gap: 12px; align-items: center; }
  .filters select { background: var(--surface); color: var(--ink-2);
                    border: 1px solid var(--ring); border-radius: 6px; padding: 4px 8px; }
  main { display: grid; grid-template-columns: repeat(auto-fit, minmax(380px, 1fr));
         gap: 14px; padding: 8px 20px 20px; }
  .card { background: var(--surface); border: 1px solid var(--ring);
          border-radius: 10px; padding: 12px 14px; }
  .card h2 { font-size: 12px; font-weight: 600; color: var(--ink);
             margin: 0 0 2px; }
  .card .sub { color: var(--muted); font-size: 11px; margin: 0 0 8px; }
  .legend { display: flex; gap: 14px; font-size: 11px; color: var(--ink-2);
            margin: 4px 0 0; }
  .legend .sw { display: inline-block; width: 10px; height: 10px;
                border-radius: 3px; margin-right: 5px; vertical-align: -1px; }
  svg text { fill: var(--muted); font: 10px system-ui, sans-serif; }
  svg .tick-label { font-variant-numeric: tabular-nums; }
  .tooltip { position: fixed; pointer-events: none; background: #222221;
             border: 1px solid var(--ring); border-radius: 6px; padding: 6px 9px;
             font-size: 11px; color: var(--ink); display: none; z-index: 10;
             font-variant-numeric: tabular-nums; }
  #alerts .alert { display: flex; gap: 8px; align-items: baseline;
                   padding: 5px 0; border-bottom: 1px solid var(--grid); }
  #alerts .alert:last-child { border-bottom: none; }
  .badge { font-weight: 600; font-size: 11px; }
  .badge::before { margin-right: 4px; }
  .badge.critical { color: var(--crit); } .badge.critical::before { content: "\\2716"; }
  .badge.warning  { color: var(--warn); } .badge.warning::before  { content: "\\26A0"; }
  .badge.ok       { color: var(--good); } .badge.ok::before       { content: "\\2714"; }
  .empty { color: var(--muted); font-size: 12px; padding: 8px 0; }
</style></head><body>
<header>
  <h1>repro run monitor</h1>
  <span class="meta" id="run-meta">loading…</span>
</header>
<div class="filters">
  <label for="tag">stream</label>
  <select id="tag"></select>
  <span class="meta" id="row-count"></span>
</div>
<main>
  <div class="card"><h2>Loss</h2><p class="sub">honest-mean loss per tick</p>
    <div id="c-loss"></div></div>
  <div class="card"><h2>Gradient norm</h2><p class="sub">honest-mean per-node l2</p>
    <div id="c-grad"></div></div>
  <div class="card"><h2>Consensus distance</h2>
    <p class="sub">max honest deviation from the honest mean</p>
    <div id="c-cons"></div></div>
  <div class="card"><h2>Message staleness</h2>
    <p class="sub">delivered-message age quantiles (net paths)</p>
    <div id="c-stale"></div>
    <div class="legend">
      <span><span class="sw" style="background:var(--s1)"></span>p50</span>
      <span><span class="sw" style="background:var(--s2)"></span>p90</span>
    </div></div>
  <div class="card"><h2>Screening</h2>
    <p class="sub">trim + trust-eviction fractions</p>
    <div id="c-screen"></div>
    <div class="legend">
      <span><span class="sw" style="background:var(--s1)"></span>trim_frac</span>
      <span><span class="sw" style="background:var(--s2)"></span>evicted_frac</span>
    </div></div>
  <div class="card"><h2>Alerts</h2>
    <p class="sub">threshold rules over the metric stream</p>
    <div id="alerts"><div class="empty">none</div></div></div>
</main>
<div class="tooltip" id="tip"></div>
<script>
"use strict";
const COLORS = ["var(--s1)", "var(--s2)", "var(--s3)"];
const state = { rows: [], tag: null, tags: [] };

function fmt(v) {
  if (v === null || v === undefined) return "–";
  const a = Math.abs(v);
  if (a !== 0 && (a < 1e-3 || a >= 1e5)) return v.toExponential(2);
  return +v.toFixed(4);
}

// Minimal SVG line chart: series = [{name, color, pts: [[x, y], ...]}].
// Hover layer: vertical crosshair + nearest-tick tooltip (interaction.md).
function lineChart(el, series, width, height) {
  el.innerHTML = "";
  const pad = { l: 44, r: 10, t: 8, b: 20 };
  const live = series.filter(s => s.pts.length > 0);
  if (!live.length) { el.innerHTML = '<div class="empty">no data</div>'; return; }
  const xs = live.flatMap(s => s.pts.map(p => p[0]));
  const ys = live.flatMap(s => s.pts.map(p => p[1]));
  let x0 = Math.min(...xs), x1 = Math.max(...xs);
  let y0 = Math.min(...ys), y1 = Math.max(...ys);
  if (x0 === x1) x1 = x0 + 1;
  if (y0 === y1) { y0 -= 0.5; y1 += 0.5; }
  const X = x => pad.l + (x - x0) / (x1 - x0) * (width - pad.l - pad.r);
  const Y = y => height - pad.b - (y - y0) / (y1 - y0) * (height - pad.t - pad.b);
  const ns = "http://www.w3.org/2000/svg";
  const svg = document.createElementNS(ns, "svg");
  svg.setAttribute("viewBox", `0 0 ${width} ${height}`);
  svg.style.width = "100%";
  // recessive grid: 3 hairlines + tick labels
  for (let i = 0; i <= 2; i++) {
    const yv = y0 + (y1 - y0) * i / 2, gy = Y(yv);
    const ln = document.createElementNS(ns, "line");
    ln.setAttribute("x1", pad.l); ln.setAttribute("x2", width - pad.r);
    ln.setAttribute("y1", gy); ln.setAttribute("y2", gy);
    ln.setAttribute("stroke", i === 0 ? "var(--axis)" : "var(--grid)");
    svg.appendChild(ln);
    const tx = document.createElementNS(ns, "text");
    tx.setAttribute("x", pad.l - 6); tx.setAttribute("y", gy + 3);
    tx.setAttribute("text-anchor", "end"); tx.setAttribute("class", "tick-label");
    tx.textContent = fmt(yv);
    svg.appendChild(tx);
  }
  [x0, x1].forEach((xv, i) => {
    const tx = document.createElementNS(ns, "text");
    tx.setAttribute("x", X(xv)); tx.setAttribute("y", height - 6);
    tx.setAttribute("text-anchor", i ? "end" : "start");
    tx.setAttribute("class", "tick-label");
    tx.textContent = Math.round(xv);
    svg.appendChild(tx);
  });
  for (const s of live) {
    const path = document.createElementNS(ns, "path");
    path.setAttribute("d", s.pts.map((p, i) =>
      `${i ? "L" : "M"}${X(p[0]).toFixed(1)},${Y(p[1]).toFixed(1)}`).join(""));
    path.setAttribute("fill", "none");
    path.setAttribute("stroke", s.color);
    path.setAttribute("stroke-width", "2");
    path.setAttribute("stroke-linejoin", "round");
    svg.appendChild(path);
  }
  // crosshair + tooltip
  const cross = document.createElementNS(ns, "line");
  cross.setAttribute("y1", pad.t); cross.setAttribute("y2", height - pad.b);
  cross.setAttribute("stroke", "var(--muted)"); cross.setAttribute("stroke-dasharray", "3 3");
  cross.style.display = "none";
  svg.appendChild(cross);
  const tip = document.getElementById("tip");
  svg.addEventListener("mousemove", ev => {
    const r = svg.getBoundingClientRect();
    const mx = (ev.clientX - r.left) / r.width * width;
    const tickX = x0 + (mx - pad.l) / (width - pad.l - pad.r) * (x1 - x0);
    let best = null, bd = Infinity;
    for (const s of live) for (const p of s.pts) {
      const d = Math.abs(p[0] - tickX);
      if (d < bd) { bd = d; best = p[0]; }
    }
    if (best === null) return;
    cross.setAttribute("x1", X(best)); cross.setAttribute("x2", X(best));
    cross.style.display = "";
    const lines = [`tick ${best}`];
    for (const s of live) {
      const p = s.pts.find(p => p[0] === best);
      if (p) lines.push(`${s.name}: ${fmt(p[1])}`);
    }
    tip.innerHTML = lines.join("<br>");
    tip.style.display = "block";
    tip.style.left = (ev.clientX + 14) + "px";
    tip.style.top = (ev.clientY + 10) + "px";
  });
  svg.addEventListener("mouseleave", () => {
    cross.style.display = "none"; tip.style.display = "none";
  });
  el.appendChild(svg);
}

function pts(rows, col) {
  return rows.filter(r => r[col] !== null && r[col] !== undefined)
             .map(r => [r.tick, r[col]]);
}

function redraw() {
  const rows = state.rows.filter(r => r.tag === state.tag);
  document.getElementById("row-count").textContent =
    rows.length ? `${rows.length} ticks (last: ${rows[rows.length - 1].tick})` : "no rows yet";
  const W = 420, H = 170;
  lineChart(document.getElementById("c-loss"),
    [{ name: "loss", color: COLORS[0], pts: pts(rows, "loss") }], W, H);
  lineChart(document.getElementById("c-grad"),
    [{ name: "grad_norm", color: COLORS[0], pts: pts(rows, "grad_norm") }], W, H);
  lineChart(document.getElementById("c-cons"),
    [{ name: "consensus_dist", color: COLORS[0], pts: pts(rows, "consensus_dist") }], W, H);
  lineChart(document.getElementById("c-stale"), [
    { name: "p50", color: COLORS[0], pts: pts(rows, "stale_p50") },
    { name: "p90", color: COLORS[1], pts: pts(rows, "stale_p90") },
  ], W, H);
  lineChart(document.getElementById("c-screen"), [
    { name: "trim_frac", color: COLORS[0], pts: pts(rows, "trim_frac") },
    { name: "evicted_frac", color: COLORS[1], pts: pts(rows, "evicted_frac") },
  ], W, H);
}

function renderAlerts(alerts) {
  const el = document.getElementById("alerts");
  if (!alerts.length) { el.innerHTML = '<div class="empty">none</div>'; return; }
  el.innerHTML = alerts.map(a => {
    const sev = a.kind === "divergence" ? "critical" : "warning";
    return `<div class="alert"><span class="badge ${sev}">${a.kind}</span>` +
           `<span>${a.tag} @ tick ${a.tick}</span></div>`;
  }).join("");
}

async function poll() {
  try {
    const run = await (await fetch("/api/run")).json();
    const m = run.manifest || {};
    const env = m.environment || {};
    document.getElementById("run-meta").textContent =
      `${run.run_dir} · ${m.kind || "run"} · git ${(m.git_sha || "?").slice(0, 10)}` +
      ` · torch ${env.torch || "?"} on ${env.backend || "?"} (${env.device_kind || "?"})` +
      ` · ${run.rows} rows · ${run.alerts.length} alerts`;
    renderAlerts(run.alerts);
    const sel = document.getElementById("tag");
    if (run.tags.join() !== state.tags.join()) {
      state.tags = run.tags;
      sel.innerHTML = run.tags.map(t => `<option>${t}</option>`).join("");
      if (!state.tag || !run.tags.includes(state.tag)) state.tag = run.tags[0] || null;
      sel.value = state.tag;
    }
    if (state.tag) {
      const res = await (await fetch(`/api/metrics?tag=${encodeURIComponent(state.tag)}`)).json();
      state.rows = res.rows;
      redraw();
    }
  } catch (e) { /* server restarting: retry on the next tick */ }
}

document.getElementById("tag").addEventListener("change", ev => {
  state.tag = ev.target.value;
  poll();
});
poll();
setInterval(poll, 2000);
</script></body></html>
"""


if __name__ == "__main__":
    raise SystemExit(main())
