"""Structured grid results — port of `repro.sim.results`: the contract
between the engine, the resumable sweep store, and the benchmark/figure
consumers.  The JSON schema is the reference's, so a store written by
either package resumes in the other.

A `GridResult` is the host-side record of one engine run: a list of per-cell
records (axes + final/averaged metrics) plus run metadata (wall time,
cells/sec, trace count, banks).  It serializes to one aggregate JSON
(`save`) and, for resumable sweeps, to one JSON per cell keyed by the cell's
stable tag (`save_cells` / `existing_tags`) — re-running a sweep only
computes the cells whose files are missing.  `rows()` renders the CSV rows
`benchmarks.run` prints, so `benchmarks/paper_figs.py` and
`benchmarks/grid_bench.py` consume grid runs through one type.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from collections.abc import Callable, Sequence

import numpy as np

from repro_torch.sim.grid import Cell

# ---------------------------------------------------------------------------
# Metric-stream reducer registry
# ---------------------------------------------------------------------------
#
# `collect` used to reduce two hardcoded key tuples — any other engine metric
# stream vanished silently (``rho`` and ``active_links`` already had).  The
# registry is extensible: subsystems that add metric streams register a
# reducer for them (in the reference `repro.obs.trace` and
# `repro.trust.reputation` register theirs at import; here they are
# registered below, beside the engine's), and `collect`
# *warns* on streams nothing registered instead of dropping them without a
# trace.

_REDUCERS: dict[str, tuple[str, Callable[[np.ndarray], float]]] = {}


def register_reducer(key: str, out_key: str, fn: Callable[[np.ndarray], float]) -> None:
    """Register ``fn`` to reduce the per-tick stream ``key`` ([T] per cell)
    into the cell-record field ``out_key``."""
    _REDUCERS[key] = (out_key, fn)


def register_final(key: str) -> None:
    """Reduce ``key`` to its final tick as ``final_<key>``."""
    register_reducer(key, f"final_{key}", lambda a: float(a[-1]))


def register_mean(key: str) -> None:
    """Reduce ``key`` to its tick-mean as ``mean_<key>`` (keys already
    ``mean_``-prefixed keep their name — no double prefix)."""
    out = key if key.startswith("mean_") else f"mean_{key}"
    register_reducer(key, out, lambda a: float(a.mean()))


for _k in ("loss", "consensus_dist", "ef_residual_norm", "rho"):
    register_final(_k)
for _k in ("delivered_frac", "mean_staleness", "screened_frac", "usable_in",
           "wire_bits_per_edge", "wire_bytes_total", "active_links"):
    register_mean(_k)
# chunk-streaming per-block trim stream (repro.stream / repro.obs): a [T, NB]
# stream per cell; the mean reducer collapses ticks AND blocks, matching the
# scalar obs_trim_frac semantics at NB = 1
register_mean("stream_block_trim_frac")
# the trace's live-edge mean trim fraction and the trust layer's evicted
# share (repro_torch.obs.trace, repro_torch.trust.reputation)
register_mean("obs_trim_frac")
register_mean("trust_evicted_frac")
# the metrics-on step's honest-mean gradient norm (repro_torch.obs.metrics)
register_mean("grad_norm")


def collect(cells: Sequence[Cell], metrics: dict, *, meta: dict | None = None) -> "GridResult":
    """Summarize engine metrics (``[E, T]`` leaves: tensors on any device
    or arrays) into a `GridResult`."""
    host = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in metrics.items()}
    unregistered = sorted(k for k in host if k not in _REDUCERS)
    if unregistered:
        warnings.warn(
            f"metric streams {unregistered} have no registered reducer and are "
            f"dropped from cell records; add one via "
            f"repro_torch.sim.results.register_reducer/register_final/register_mean "
            f"(registered: {sorted(_REDUCERS)})",
            stacklevel=2)
    records = []
    for i, c in enumerate(cells):
        rec = {
            "rule": c.rule, "attack": c.attack, "b": int(c.b), "seed": int(c.seed),
            "scenario": c.scenario, "codec": c.codec, "adversary": c.adversary,
            "mask_seed": c.mask_seed,
            "theta": None if c.theta is None else [float(x) for x in c.theta],
        }
        for k, (out_key, fn) in _REDUCERS.items():
            if k in host:
                rec[out_key] = fn(host[k][i])
        records.append(rec)
    return GridResult(cells=records, meta=dict(meta or {}))


def cell_of(record: dict) -> Cell:
    """The grid `Cell` a record describes (tag round-trips through this)."""
    theta = record.get("theta")
    mask_seed = record.get("mask_seed")
    return Cell(record["rule"], record["attack"], int(record["b"]), int(record["seed"]),
                record.get("scenario"), record.get("codec", "identity"),
                record.get("adversary", "none"),
                None if mask_seed is None else int(mask_seed),
                None if theta is None else tuple(float(x) for x in theta))


@dataclasses.dataclass
class GridResult:
    """One grid run: per-cell records + run metadata."""

    cells: list[dict]
    meta: dict

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"meta": self.meta, "cells": self.cells}, f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "GridResult":
        with open(path) as f:
            data = json.load(f)
        return cls(cells=data["cells"], meta=data.get("meta", {}))

    def save_cells(self, out_dir: str) -> None:
        """Per-cell files for the resumable sweep store (one JSON per tag)."""
        os.makedirs(out_dir, exist_ok=True)
        for rec in self.cells:
            with open(os.path.join(out_dir, cell_of(rec).tag + ".json"), "w") as f:
                json.dump(rec, f, indent=2, sort_keys=True)

    def rows(self, prefix: str = "grid") -> list[tuple[str, float, str]]:
        """CSV rows for the `benchmarks.run` harness: one row per cell, timed
        at the run's amortized us/cell."""
        us_per_cell = float(self.meta.get("us_per_cell", 0.0))
        rows = []
        for rec in self.cells:
            derived = ";".join(
                f"{k.replace('final_', '').replace('mean_', '')}={rec[k]:.4f}"
                for k in ("accuracy", "final_loss", "final_consensus_dist", "mean_delivered_frac")
                if k in rec
            )
            rows.append((f"{prefix}/{cell_of(rec).tag}", us_per_cell, derived))
        return rows


def existing_tags(out_dir: str) -> set[str]:
    """Tags already present in a per-cell result store (sweep resumability)."""
    if not os.path.isdir(out_dir):
        return set()
    return {f[:-5] for f in os.listdir(out_dir)
            if f.endswith(".json") and f != "GridResult.json"}


def load_cell_store(out_dir: str) -> GridResult:
    """Assemble a `GridResult` from every per-cell file in a store — the
    on-disk records are the source of truth, so aggregates rebuilt after a
    resumed sweep cover all runs, not just the latest."""
    records = []
    for tag in sorted(existing_tags(out_dir)):
        with open(os.path.join(out_dir, tag + ".json")) as f:
            records.append(json.load(f))
    return GridResult(cells=records, meta={"total_cells": len(records)})
