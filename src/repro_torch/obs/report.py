"""Forensics report renderer: ``python -m repro_torch.obs.report RUN_DIR``
— a copy of `repro.obs.report` (plain Python) with its imports pointing at
`repro_torch.obs` and the manifest's environment line naming the port's
stack (torch, CUDA, the card and its power limit).

Consumes what a traced run leaves on disk — ``obs_summary.json`` (per-cell
`repro_torch.obs.trace.summarize` records) and/or ``events.jsonl`` (the
`repro_torch.obs.events.EventLog` stream) — and renders the per-run summary:
top-suspect edges, survival-rate-by-rule tables, divergence sentinels, and
the phase/wall-time breakdown.  Pure host-side text.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.obs.events import read_events


def _fmt_row(cols, widths):
    return "  ".join(str(c).ljust(w) for c, w in zip(cols, widths, strict=True))


def _table(header, rows) -> list[str]:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
              for i, h in enumerate(header)]
    lines = [_fmt_row(header, widths), _fmt_row(["-" * w for w in widths], widths)]
    lines += [_fmt_row(r, widths) for r in rows]
    return lines


def render(summary: dict | None = None, events: list[dict] | None = None,
           *, top: int = 10, manifest: dict | None = None,
           metrics_rows: list[dict] | None = None) -> str:
    """The full text report; every input may be None."""
    out: list[str] = ["== BRIDGE observability report =="]

    if manifest:
        env = manifest.get("environment") or {}
        out.append("-- run manifest --")
        out.append(f"kind: {manifest.get('kind', '?')}  "
                   f"git: {(manifest.get('git_sha') or '?')[:12]}  "
                   f"config: {manifest.get('config_digest', '?')}")
        out.append(f"torch {env.get('torch', '?')} / cuda {env.get('cuda', '?')} "
                   f"on {env.get('backend', '?')} "
                   f"({env.get('device_kind', '?')} x{env.get('device_count', '?')}, "
                   f"{env.get('power_limit', '?')})")
        argv = manifest.get("argv")
        if argv:
            out.append("argv: " + " ".join(str(a) for a in argv))
        out.append("")

    if metrics_rows:
        out.append("-- live metric streams (metrics.jsonl) --")
        by_tag: dict[str, list[dict]] = {}
        for r in metrics_rows:
            by_tag.setdefault(r.get("tag", "train"), []).append(r)
        mrows = []
        for tag, rows in sorted(by_tag.items()):
            last = rows[-1]
            bad = sum(1 for r in rows if (r.get("nonfinite") or 0.0) > 0.0)
            mrows.append((
                tag, len(rows), last.get("tick"),
                "n/a" if last.get("loss") is None else f"{last['loss']:.4g}",
                "n/a" if last.get("consensus_dist") is None
                else f"{last['consensus_dist']:.4g}",
                bad,
            ))
        out += _table(("stream", "rows", "last_tick", "last_loss",
                       "last_consensus", "nonfinite_rows"), mrows)
        out.append("")

    if summary is not None:
        cells = summary.get("cells", [])
        out.append(f"cells traced: {len(cells)}")

        diverged = [(c.get("tag", f"cell{i}"), c["first_bad_tick"])
                    for i, c in enumerate(cells) if c.get("first_bad_tick") is not None]
        out.append("")
        if diverged:
            out.append("-- divergence sentinel (first non-finite tick) --")
            out += _table(("cell", "first_bad_tick"), diverged)
        else:
            out.append("-- divergence sentinel: all traced cells stayed finite --")

        surv_rows = []
        for i, c in enumerate(cells):
            s = c.get("survival")
            if not s:
                continue
            auc = c.get("auc_byzantine_edges")
            surv_rows.append((
                c.get("tag", f"cell{i}"), c.get("rule", "?"),
                f"{s['byz_trim_freq']:.3f}", f"{s['honest_trim_freq']:.3f}",
                "n/a" if auc is None else f"{auc:.3f}",
            ))
        if surv_rows:
            out.append("")
            out.append("-- screening survival by cell (trim frequency; higher = more suspected) --")
            out += _table(("cell", "rule", "byz_trim", "honest_trim", "auc"), surv_rows)

        edge_rows = []
        for i, c in enumerate(cells):
            for e in c.get("top_edges", []):
                edge_rows.append((e["trim_freq"], c.get("tag", f"cell{i}"),
                                  e["receiver"], e["sender"], e["seen"],
                                  e.get("byzantine")))
        if edge_rows:
            edge_rows.sort(key=lambda r: -r[0])
            out.append("")
            out.append(f"-- top {top} suspect edges (by trim frequency) --")
            out += _table(
                ("trim_freq", "cell", "receiver", "sender", "seen", "byzantine"),
                [(f"{f:.3f}", tag, r, s, int(n), b)
                 for f, tag, r, s, n, b in edge_rows[:top]])

    if events:
        out.append("")
        out.append("-- event stream / wall-time breakdown --")
        by_tag: dict[str, dict] = {}
        for rec in events:
            agg = by_tag.setdefault(rec["tag"], {"count": 0, "wall_s": 0.0})
            agg["count"] += 1
            agg["wall_s"] += float(rec.get("wall_s", 0.0))
        rows = [(tag, a["count"], f"{a['wall_s']:.3f}")
                for tag, a in sorted(by_tag.items())]
        out += _table(("tag", "count", "sum wall_s"), rows)
        ends = [r for r in events if r["tag"] == "run.end"]
        for r in ends:
            compile_s, steady = r.get("compile_s"), r.get("steady_state_s")
            if compile_s is not None and steady is not None:
                out.append(f"compile {compile_s:.3f}s vs steady-state {steady:.3f}s "
                           f"({r.get('label', 'run')})")
        div = [r for r in events if r["tag"] == "obs.divergence"]
        if div:
            out.append("")
            out.append("-- divergence events --")
            out += _table(("cell", "first_bad_tick"),
                          [(r.get("cell", "?"), r.get("first_bad_tick")) for r in div])
        alerts = [r for r in events if r["tag"] == "obs.alert"]
        if alerts:
            out.append("")
            out.append("-- alerts (threshold rules over the live metric stream) --")
            out += _table(("kind", "stream", "tick"),
                          [(r.get("kind", "?"), r.get("stream", "?"), r.get("tick"))
                           for r in alerts])

    return "\n".join(out) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dir", nargs="?", default=None,
                    help="directory holding obs_summary.json / events.jsonl")
    ap.add_argument("--summary", default=None, help="explicit obs_summary.json path")
    ap.add_argument("--events", default=None, help="explicit events.jsonl path")
    ap.add_argument("--top", type=int, default=10, help="suspect edges to show")
    ap.add_argument("--out", default=None, help="write the report here too")
    args = ap.parse_args(argv)

    spath = args.summary or (args.run_dir and os.path.join(args.run_dir, "obs_summary.json"))
    epath = args.events or (args.run_dir and os.path.join(args.run_dir, "events.jsonl"))
    summary = None
    if spath and os.path.exists(spath):
        with open(spath) as f:
            summary = json.load(f)
    events = read_events(epath) if epath and os.path.exists(epath) else None
    manifest = metrics_rows = None
    if args.run_dir:
        from repro_torch.obs.manifest import read_manifest
        from repro_torch.obs.metrics import read_metrics

        manifest = read_manifest(args.run_dir)
        metrics_rows = read_metrics(os.path.join(args.run_dir, "metrics.jsonl")) or None
    if summary is None and events is None and manifest is None and metrics_rows is None:
        raise SystemExit(f"no obs_summary.json, events.jsonl, manifest.json or "
                         f"metrics.jsonl found (looked at {spath!r}, {epath!r})")
    text = render(summary, events, top=args.top, manifest=manifest,
                  metrics_rows=metrics_rows)
    print(text, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
