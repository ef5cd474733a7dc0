"""Structured host-side event log: an async JSONL writer — a copy of
`repro.obs.events` (plain Python).

The host loops around the grid engine's steps write here: the engine's
chunk boundaries, the breakdown engine's probe rounds and the sweep's run
brackets.  Writes go through a queue drained by a daemon thread, so
emitting never blocks the loop that launches the card's work.

Every record is one JSON line ``{"tag": ..., "wall": <s since log open>,
"time": <unix>, **fields}``.  The tags are the reference's:

* ``run.start`` / ``run.end``      — one run bracket (engine or CLI)
* ``grid.chunk``                   — one chunk of a chunked grid run
* ``breakdown.round``              — one (rule, adversary, b) probe round
* ``obs.divergence``               — a cell's sentinel fired (first tick)
* ``profile.capture``              — a profiler trace was written
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time

import numpy as np

_SENTINEL = object()


def _jsonable(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


class EventLog:
    """Append-only JSONL event stream; safe to emit from any thread.

    The drain thread flushes at most every ``flush_interval`` seconds (and
    whenever its queue runs dry, and on close), so a burst of records costs
    one buffered ``write`` each and the emitting loop never waits on the
    file.
    """

    def __init__(self, path: str, *, flush_interval: float = 0.2):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self._f = open(path, "a")  # noqa: SIM115  (lives until .close())
        self._t0 = time.perf_counter()
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._flush_interval = max(float(flush_interval), 0.0)
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="obs-eventlog")
        self._thread.start()

    def emit(self, tag: str, **fields) -> None:
        if self._closed:
            return
        rec = {"tag": str(tag), "wall": round(time.perf_counter() - self._t0, 6),
               "time": time.time()}
        rec.update(fields)
        self._q.put(rec)

    def _drain(self) -> None:
        last_flush = time.perf_counter()
        while True:
            try:
                rec = self._q.get(timeout=self._flush_interval or 0.05)
            except queue.Empty:
                self._f.flush()
                last_flush = time.perf_counter()
                continue
            if rec is _SENTINEL:
                break
            self._f.write(json.dumps(rec, sort_keys=True, default=_jsonable) + "\n")
            now = time.perf_counter()
            if self._q.empty() or now - last_flush >= self._flush_interval:
                self._f.flush()
                last_flush = now
        self._f.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(_SENTINEL)
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            # the drain thread is still writing: closing the file here would
            # race it, so the daemon thread keeps the file
            return
        self._f.close()

    def __enter__(self) -> EventLog:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> list[dict]:
    """Parse an event log back into records; tolerates a truncated final
    line from an interrupted run."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records
