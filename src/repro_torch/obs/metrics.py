"""Live per-tick metric rings — port of `repro.obs.metrics`.

`repro_torch.obs.trace` answers post-mortem questions; this module is the
live layer.  A `MetricSpec` adds a small ``[C, S]`` ring of per-tick
scalar streams (loss, grad norm, trim fraction, eviction fraction, wire
bits, staleness quantiles, the non-finite sentinel) to the step's state
(``BridgeState.mets``), the chunked runner
(`repro_torch.core.bridge.BridgeTrainer.run_chunks`) hands the ring to a
`MetricWriter` after each chunk, and the writer's thread appends one JSON
line a tick to ``metrics.jsonl`` — the reference's schema, so either
package's `read_metrics`, `repro_torch.obs.monitor` and
`repro.obs.monitor` read the port's runs.

The ring stays on the device: `update` writes slot ``count % capacity``
with a scatter from the device ``count`` (the tick's host values in one
pinned copy that does not wait for the stream), and reads nothing back, so
a tick adds no host sync.  ``metrics=None`` (the default everywhere) keeps every
step's metric-free path, and metrics on is bit-inert: the ring only reads
values the step already computes.

Ring semantics: ``buf[count % capacity]`` is overwritten round-robin, so a
chunk of up to ``capacity`` ticks survives intact between flushes (the
chunked runner defaults its chunk length to the spec's capacity).  Columns
a configuration does not produce (staleness on the synchronous path, the
eviction fraction without a trust spec) hold NaN and render as ``null``.

Threshold alerting (`AlertRules`, `AlertEngine`) is host logic shared by
the writer, which emits ``obs.alert`` events into the run's `EventLog`, and
the live monitor, which re-runs it over a tailed ``metrics.jsonl``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import queue
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch

# The ring's columns (S = len(COLUMNS)): the device layout and the JSONL
# field order, the reference's.
COLUMNS = (
    "tick",                # the tick, state.t: the ring's dedup key
    "loss",                # honest-mean loss
    "consensus_dist",      # max honest deviation from the honest mean
    "grad_norm",           # honest-mean per-node gradient l2 norm
    "rho",                 # step size
    "trim_frac",           # live-edge-mean screening trim fraction (decide path)
    "wire_bits_per_edge",  # codec codeword size
    "wire_bytes_total",    # bytes put on the wire this tick
    "evicted_frac",        # the trust layer's evicted edge fraction
    "stale_p50",           # delivered-message age median (net paths)
    "stale_p90",           # delivered-message age 90th percentile
    "nonfinite",           # 1.0 when the tick's loss or consensus went non-finite
)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """What the step streams: the ring's ``capacity`` in ticks (the chunked
    runner flushes once a chunk and defaults the chunk to it, so no tick is
    overwritten before it is read)."""

    capacity: int = 64

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"invalid MetricSpec: {self}")


class MetricState(NamedTuple):
    """The carried ring (one a cell; the grids stack a leading ``[E]``)."""

    buf: torch.Tensor    # [.., capacity, S] float32, NaN = slot never written
    count: torch.Tensor  # [..] int32, ticks folded so far


def init_state(spec: MetricSpec | None, *, lead: tuple = (),
               device: str | torch.device = "cuda") -> MetricState | None:
    """A fresh NaN-filled ring (``lead=(E,)`` stacks a grid's worth)."""
    if spec is None:
        return None
    return MetricState(
        buf=torch.full((*lead, spec.capacity, len(COLUMNS)), float("nan"), dtype=torch.float32,
                       device=device),
        count=torch.zeros(lead, dtype=torch.int32, device=device))


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` by a copy from pinned memory that does not
    wait for the stream (on the CPU, the array itself)."""
    t = torch.from_numpy(host)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@functools.lru_cache(maxsize=64)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, copied over once."""
    return _to_device(np.asarray(values, torch.empty((), dtype=dtype).numpy().dtype), device)


def update(spec: MetricSpec, st: MetricState, *, t: int, vals: dict) -> MetricState:
    """Fold one tick's scalars into the ring.  ``vals`` maps column names to
    the tick's values (``[..]`` tensors on the device, or host numbers);
    absent columns stay NaN.  The host values travel in one pinned copy,
    the device ones are stacked into the row, and the slot ``count %
    capacity`` comes from the device count: nothing is read back."""
    lead = tuple(st.count.shape)
    dev = st.buf.device
    host = np.full((*lead, len(COLUMNS)), np.nan, np.float32)
    host[..., 0] = t
    on_dev = []
    for i, name in enumerate(COLUMNS[1:-1], start=1):
        v = vals.get(name)
        if isinstance(v, torch.Tensor):
            on_dev.append((i, v))
        elif v is not None:
            host[..., i] = np.broadcast_to(np.asarray(v, np.float32), lead)
    row = _to_device(host, dev)
    if on_dev:
        cols = torch.stack([v.to(torch.float32).expand(lead) for _, v in on_dev], dim=-1)
        row = row.index_copy(-1, _constant(tuple(i for i, _ in on_dev), torch.int64, dev), cols)
    # the sentinel: the tick's loss or consensus went non-finite
    bad = ~torch.isfinite(row[..., 1:3]).all(dim=-1, keepdim=True)
    row = torch.cat([row[..., :-1], bad.to(torch.float32)], dim=-1)
    slot = (st.count % spec.capacity).to(torch.int64)
    idx = slot[..., None, None].expand(*lead, 1, len(COLUMNS))
    return MetricState(buf=st.buf.scatter(-2, idx, row[..., None, :]), count=st.count + 1)


_QUANTILES = (0.5, 0.9)


def stale_quantiles(staleness: torch.Tensor, live: torch.Tensor) -> dict:
    """The ``stale_p50`` / ``stale_p90`` columns from the ``[.., M, W]``
    delivered-message ages and their live mask: ``jnp.nanquantile``'s
    linear interpolation, its arithmetic step for step (NaN over dead
    slots sorts last; ranks ``q (n - 1)`` between the floor and the ceil;
    ``low (1 - w) + high w``), both quantiles from one sort, and NaN where
    no slot is live."""
    vals = torch.where(live.bool(), staleness.to(torch.float32), float("nan"))
    flat = vals.reshape(*vals.shape[:-2], -1)
    srt = torch.sort(flat, dim=-1).values
    n = torch.sum(~torch.isnan(flat), dim=-1, keepdim=True).to(torch.float32)
    last = n - 1.0
    pos = _constant(_QUANTILES, torch.float32, flat.device) * last
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    at = lambda r: srt.gather(-1, torch.clamp(torch.minimum(r, last), min=0.0).to(torch.int64))
    q = at(low) * w_low + at(high) * w_high
    return {"stale_p50": q[..., 0], "stale_p90": q[..., 1]}


def rows_of(buf, count, *, after: int = -1) -> list[dict]:
    """Host-side ring decode: tick-ordered JSON-ready rows, skipping ticks
    ``<= after`` (the writer's per-tag dedup across overlapping flushes) and
    rendering NaN columns as None."""
    buf = np.asarray(buf)
    count = int(count)
    c = buf.shape[0]
    rows = []
    for i in range(max(count - c, 0), count):
        row = buf[i % c]
        if not np.isfinite(row[0]):
            continue  # slot never written (short first chunk)
        tick = int(row[0])
        if tick <= after:
            continue
        rec: dict[str, Any] = {"tick": tick}
        for name, v in zip(COLUMNS[1:], row[1:], strict=True):
            rec[name] = float(v) if math.isfinite(float(v)) else None
        rows.append(rec)
    return rows


# ---------------------------------------------------------------------------
# Threshold alert rules (shared by the writer and the live monitor)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AlertRules:
    """Host-side thresholds evaluated on every metric row.  Each kind latches
    per (tag, kind) so a persistent condition alerts once, not per tick."""

    divergence: bool = True  # the nonfinite sentinel fired
    # loss > factor * the running minimum (a blow-up, not normal noise)
    loss_spike_factor: float = 100.0
    # evicted_frac rose by more than this between consecutive rows
    evict_spike: float = 0.25
    # cumulative wire_bytes_total crossed this budget (None = unmetered)
    wire_budget_bytes: float | None = None


class AlertEngine:
    """Stateful evaluator: ``feed(tag, row) -> [alert dicts]``."""

    def __init__(self, rules: AlertRules | None = None):
        self.rules = rules or AlertRules()
        self._loss_min: dict[str, float] = {}
        self._evicted: dict[str, float] = {}
        self._wire: dict[str, float] = {}
        self._fired: set[tuple[str, str]] = set()

    def _fire(self, tag: str, kind: str, tick: int, **fields) -> dict | None:
        if (tag, kind) in self._fired:
            return None
        self._fired.add((tag, kind))
        return {"kind": kind, "tag": tag, "tick": tick, **fields}

    def feed(self, tag: str, row: dict) -> list[dict]:
        r = self.rules
        tick = int(row.get("tick", -1))
        out = []
        if r.divergence and (row.get("nonfinite") or 0.0) > 0.0:
            a = self._fire(tag, "divergence", tick)
            if a:
                out.append(a)
        loss = row.get("loss")
        if loss is not None and math.isfinite(loss):
            lo = self._loss_min.get(tag)
            if lo is not None and lo > 0.0 and loss > r.loss_spike_factor * lo:
                a = self._fire(tag, "loss_spike", tick, loss=loss, running_min=lo)
                if a:
                    out.append(a)
            self._loss_min[tag] = loss if lo is None else min(lo, loss)
        ev = row.get("evicted_frac")
        if ev is not None:
            prev = self._evicted.get(tag, 0.0)
            if ev - prev > r.evict_spike:
                a = self._fire(tag, "eviction_spike", tick, evicted_frac=ev, previous=prev)
                if a:
                    out.append(a)
            self._evicted[tag] = ev
        wire = row.get("wire_bytes_total")
        if r.wire_budget_bytes is not None and wire is not None:
            tot = self._wire.get(tag, 0.0) + wire
            self._wire[tag] = tot
            if tot > r.wire_budget_bytes:
                a = self._fire(tag, "wire_budget", tick, wire_bytes_cumulative=tot,
                               budget=r.wire_budget_bytes)
                if a:
                    out.append(a)
        return out


# ---------------------------------------------------------------------------
# The background writer
# ---------------------------------------------------------------------------

_SENTINEL = object()


class MetricWriter:
    """Appends flushed rings to ``metrics.jsonl`` from a daemon thread
    without blocking the loop that launches the card's work.

    ``flush(mstate, tag=...)`` starts a ``non_blocking`` copy of the ring
    into pinned host memory on the current stream, records a CUDA event
    behind it and returns; the drain thread waits on that event (never on
    the stream), then writes the rows.  The copy is the ring's snapshot at
    that point of the stream, which no later kernel can change (the steps
    never write a ring in place).  On the CPU the copy is made at once.

    One JSON line per tick: ``{"tag", "wall", <COLUMNS...>}``.  Overlapping
    flushes of the same tag are deduped by tick; per-row walls are
    interpolated between consecutive flush walls (the Perfetto counter
    track's timestamps).  ``alerts`` / ``events`` route the flushed rows
    through an `AlertEngine` into ``obs.alert`` event records.
    """

    def __init__(self, path: str, *, alerts: AlertRules | None = None, events=None,
                 flush_interval: float = 0.2):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self._f = open(path, "a")  # noqa: SIM115  (lives until .close())
        self._t0 = time.perf_counter()
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._flush_interval = flush_interval
        self._last_tick: dict[str, int] = {}
        self._last_wall: dict[str, float] = {}
        self._alerts = None if alerts is None else AlertEngine(alerts)
        self._events = events
        self.rows_written = 0
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="obs-metricwriter")
        self._thread.start()

    @staticmethod
    def _to_host(x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return x.detach().clone()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        return host

    def flush(self, mstate: MetricState | None, *, tag: str = "train", tags=None) -> None:
        """Enqueue one ring (``[C, S]`` buf) or a stacked batch of rings
        (``[E, C, S]`` buf with ``tags`` naming each row)."""
        if mstate is None or self._closed:
            return
        buf, count = self._to_host(mstate.buf), self._to_host(mstate.count)
        done = None
        if mstate.buf.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(mstate.buf.device))
        self._q.put((tag, tags, buf, count, done, time.perf_counter() - self._t0))

    def _write_rows(self, tag: str, buf, count, wall: float) -> None:
        rows = rows_of(buf, count, after=self._last_tick.get(tag, -1))
        if not rows:
            return
        w0 = self._last_wall.get(tag, wall)
        for i, rec in enumerate(rows):
            rec_wall = w0 + (wall - w0) * (i + 1) / len(rows)
            line = {"tag": tag, "wall": round(rec_wall, 6), **rec}
            self._f.write(json.dumps(line) + "\n")
            self.rows_written += 1
            if self._alerts is not None:
                for alert in self._alerts.feed(tag, rec):
                    if self._events is not None:
                        # `stream`, not `tag`: the event record's "tag" field
                        # is the event name and fields must not collide
                        a = dict(alert)
                        a["stream"] = a.pop("tag")
                        self._events.emit("obs.alert", **a)
        self._last_tick[tag] = rows[-1]["tick"]
        self._last_wall[tag] = wall

    def _drain(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=self._flush_interval)
            except queue.Empty:
                self._f.flush()
                continue
            if item is _SENTINEL:
                break
            tag, tags, buf, count, done, wall = item
            if done is not None:
                done.synchronize()  # the copy, not the stream
            buf, count = buf.numpy(), count.numpy()
            if tags is not None:
                for i, t in enumerate(tags):
                    self._write_rows(str(t), buf[i], count[i], wall)
            else:
                self._write_rows(tag, buf, count, wall)
            if self._q.empty():
                self._f.flush()
        self._f.flush()

    def close(self) -> None:
        """Drain every queued ring into the file, then close it."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_SENTINEL)
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            # a wedged copy: leave the file to the daemon thread rather
            # than closing it out from under an in-flight write
            return
        self._f.close()

    def __enter__(self) -> MetricWriter:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_metrics(path: str, *, after: int = -1, tag: str | None = None) -> list[dict]:
    """Parse ``metrics.jsonl`` back into row dicts (monitor/report/perfetto
    input); tolerates a truncated final line from a killed run."""
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if tag is not None and rec.get("tag") != tag:
                continue
            if int(rec.get("tick", -1)) <= after:
                continue
            rows.append(rec)
    return rows

