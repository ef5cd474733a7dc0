"""Breakdown-point certification: the largest b a (rule, topology,
adversary) triple tolerates — port of `repro.adversary.breakdown`.

Every probe (rule, adversary, b, seed) is one cell of the grid engine
(`repro_torch.sim.GridEngine`), and a probe *round* runs every pending
probe of every (rule, adversary) pair as one engine run on the card: each
screening kernel launches once a tick for a group of cells.

* ``mode="ladder"`` probes every feasible b in one round;
  ``mode="bisect"`` binary-searches b* per pair, ceil(log2(b_max + 1))
  rounds, then probes the prefix the search skipped;
* a cell diverges when its loss trace goes non-finite, its final honest
  loss exceeds ``loss_ratio`` times the faultless (b = 0) reference's, or,
  with a host-side ``eval_fn``, its score drops more than ``score_drop``
  below the reference's (only the seeds that stayed finite are scored);
* certification is monotone: b* is the longest all-surviving prefix, and
  ``certified_monotone`` says whether it agrees with the search's answer;
* the trace's sentinel (`repro_torch.obs.TraceSpec(forensics=False)`, the
  default) dates each diverging probe (``first_bad_tick``) and, with an
  ``events`` log, emits ``obs.divergence`` and ``breakdown.round``.

The reference counts compilations (``compiles``); the port runs eagerly,
so ``compiles`` is the sum of each round's `GridEngine.num_steps_built`
(one step a group).  ``trust`` (a `repro_torch.trust.TrustSpec`) runs
every probe with the trust layer: the detect-and-expel ladder of the
reference's ``benchmarks/trust_bench.py``, where a ``rep_*`` rule's
``b + 1`` degree requirement (`screening.MIN_NEIGHBORS`) lets it certify
past the static ``2b + 1`` wall.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import screening
from repro_torch.device import resolve_device, wait
from repro_torch.obs import TraceSpec
from repro_torch.sim import Cell, ExperimentGrid, GridEngine

# ctor sentinel: "use the default sentinel-only trace" (pass trace=None to
# run with observability off)
_DEFAULT_TRACE = object()


@dataclasses.dataclass(frozen=True)
class BreakdownConfig:
    """Knobs of the certification run (the reference's).

    ``b_max`` caps the searched range (None: whatever the topology's minimum
    in-degree admits per rule); ``loss_ratio`` is the divergence threshold
    relative to the faultless reference's final loss; ``score_drop`` (with
    an ``eval_fn``) flags cells whose host-side score fell that far below
    the reference's; ``seeds`` must all survive for a probe to survive.
    ``measure_compile`` runs each round twice to split ``compile_s`` from
    ``steady_state_s`` in the meta (see `BreakdownEngine`).
    """

    b_max: int | None = None
    seeds: tuple[int, ...] = (0,)
    loss_ratio: float = 4.0
    score_drop: float | None = None
    mode: str = "ladder"  # ladder | bisect
    measure_compile: bool = False


def feasible_b(rule: str, topology, b_cap: int | None = None) -> int:
    """The largest b whose Table-II minimum in-degree the topology satisfies
    (never more than M - 2: at least one honest pair must remain)."""
    m = topology.num_nodes
    hi = 0
    for b in range(1, m - 1):
        if screening.min_neighbors(rule, b) > topology.min_in_degree:
            break
        hi = b
    return hi if b_cap is None else min(hi, b_cap)


def _leading_ticks(batches) -> int:
    """T of the batches: the leading axis of their first tensor."""
    first = batches[0] if isinstance(batches, (tuple, list)) else batches
    return int(first.shape[0])


class BreakdownEngine:
    """Certifies b* for every (rule, adversary) pair over one topology.

    ``grad_fn`` / ``init_fn`` / ``batches`` are the `GridEngine` contract
    (``batches`` stacked ``[T, ...]`` on the device, e.g.
    ``linear_task(M, T).batches``); ``eval_fn(params, honest_mask)``, when
    given, scores one cell's final ``[M, ...]`` params on the host (higher
    is better, e.g. honest test accuracy).  ``scenario`` moves every probe
    onto the network runtime (a `repro_torch.net.scenarios` name): the net
    grids, whose screens are the views kernels with the experiment axis.

    ``measure_compile`` keeps the reference's ``compile_s`` /
    ``steady_state_s``: each round runs twice and ``compile_s`` is the
    first run's wall time less the second's.  On the card that excess is
    the kernels' build and load at their first launch and the caching
    allocator's warm-up, not a compilation of the step (PyTorch runs
    eagerly).  The field keeps the reference's name because the port's obs
    CLIs and ``report`` read the reference's schema.

    Usage::

        eng = BreakdownEngine(topo, ["trimmed_mean"], ["alie_online"],
                              task.grad_fn, task.init_fn, task.batches)
        result = eng.run()  # result["rules"][rule]["adversaries"][adv]["bstar"]
    """

    def __init__(self, topology, rules: Sequence[str], adversaries: Sequence[str],
                 grad_fn: Callable, init_fn: Callable, batches, *,
                 lam: float = 1.0, t0: float = 30.0,
                 config: BreakdownConfig = BreakdownConfig(),
                 eval_fn: Callable | None = None,
                 engine_chunk: int | None = None,
                 trace=_DEFAULT_TRACE, trust=None,
                 scenario: str | None = None, events=None,
                 device: str | torch.device = "cuda"):
        if "none" in adversaries:
            raise ValueError("'none' is the reference, not a certifiable adversary")
        self.device = resolve_device(device)
        self.topology = topology
        self.rules = tuple(rules)
        self.adversaries = tuple(adversaries)
        self.grad_fn = grad_fn
        self.init_fn = init_fn
        self.batches = batches
        self.lam, self.t0 = lam, t0
        self.config = config
        self.eval_fn = eval_fn
        self.engine_chunk = engine_chunk
        # sentinel-only trace by default: a diverging probe is dated (its
        # first bad tick) instead of inferred from NaNs; bit-inert
        self.trace = (TraceSpec(forensics=False, sentinel=True)
                      if trace is _DEFAULT_TRACE else trace)
        self.trust = trust
        self.scenario = scenario
        # net-mode grids need the schedule length up front
        self.num_ticks = _leading_ticks(batches)
        self.events = events
        self.compiles = 0
        self.cells_run = 0
        self.compile_s = 0.0
        self.steady_state_s = 0.0
        self.feasible = {r: feasible_b(r, topology, config.b_max) for r in self.rules}
        # probe ledger: (rule, adversary, b) -> record dict
        self.probes: dict[tuple[str, str, int], dict] = {}
        self.refs: dict[str, dict] = {}
        # the engine of each round, in order (launch counts, diagnostics)
        self.round_engines: list[GridEngine] = []

    # -- one batched probe round ------------------------------------------

    def _grid(self) -> ExperimentGrid:
        return ExperimentGrid(
            self.topology, self.rules, ("none",), byzantine_counts=(0,),
            seeds=self.config.seeds,
            scenarios=None if self.scenario is None else (self.scenario,),
            adversaries=("none",) + self.adversaries,
            lam=self.lam, t0=self.t0,
        )

    def _run_round(self, keys: list[tuple[str, str, int]]) -> None:
        """Run every (rule, adversary, b) probe (x seeds) as one engine run
        and record per-probe aggregates in the ledger."""
        keys = [k for k in keys if k not in self.probes]
        if not keys:
            return
        cells = [Cell(rule, "none", b, s, scenario=self.scenario,
                      adversary=adv, mask_seed=s)
                 for (rule, adv, b) in keys for s in self.config.seeds]
        engine = GridEngine(self._grid(), self.grad_fn, cells=cells, trace=self.trace,
                            trust=self.trust,
                            num_ticks=self.num_ticks if self.scenario else None,
                            device=self.device)
        self.round_engines.append(engine)
        state = engine.init(self.init_fn)
        t0 = time.perf_counter()
        final, metrics = engine.run(state, self.batches, chunk=self.engine_chunk)
        wait(self.device)
        wall = time.perf_counter() - t0
        if self.config.measure_compile:
            # the second run starts warm: its wall is the steady-state round
            t1 = time.perf_counter()
            engine.run(state, self.batches, chunk=self.engine_chunk)
            wait(self.device)
            steady = time.perf_counter() - t1
            self.compile_s += max(wall - steady, 0.0)
            self.steady_state_s += steady
        self.compiles += engine.num_steps_built
        self.cells_run += len(cells)
        loss = metrics["loss"].cpu().numpy().astype(np.float64)  # [E, T]
        first_bad = (final.obs.first_bad.cpu().numpy()
                     if final.obs is not None else None)  # [E] or None
        ns = len(self.config.seeds)
        for j, key in enumerate(keys):
            rows = slice(j * ns, (j + 1) * ns)
            rec = {
                "final_loss": float(np.mean(loss[rows, -1])),
                "max_final_loss": float(np.max(loss[rows, -1])),
                "finite": bool(np.isfinite(loss[rows]).all()),
            }
            if first_bad is not None:
                bad = first_bad[rows][first_bad[rows] >= 0]
                rec["first_bad_tick"] = int(bad.min()) if bad.size else None
            if self.eval_fn is not None:
                # score only the seeds that stayed finite: a diverged run's
                # params are NaN and would hide when the cell broke
                scores = []
                for i in range(j * ns, (j + 1) * ns):
                    if not np.isfinite(loss[i]).all():
                        continue
                    params_i = {k: v[i] for k, v in final.params.items()}
                    scores.append(float(self.eval_fn(params_i, ~engine.byz_masks[i])))
                rec["score"] = float(np.mean(scores)) if scores else None
            self.probes[key] = rec
            if self.events is not None and rec.get("first_bad_tick") is not None:
                self.events.emit("obs.divergence", rule=key[0], adversary=key[1],
                                 b=key[2], first_bad_tick=rec["first_bad_tick"])
        if self.events is not None:
            self.events.emit("breakdown.round", probes=len(keys), cells=len(cells),
                             wall_s=wall, compiles=engine.num_steps_built)

    def _survived(self, rule: str, adv: str, b: int) -> bool:
        rec = self.probes[(rule, adv, b)]
        ref = self.refs[rule]
        ok = rec["finite"] and rec["max_final_loss"] <= (
            self.config.loss_ratio * max(ref["final_loss"], 1e-9) + 1e-6)
        if ok and self.eval_fn is not None and self.config.score_drop is not None:
            ok = rec["score"] >= ref["score"] - self.config.score_drop
        rec["survived"] = bool(ok)
        return rec["survived"]

    # -- certification ----------------------------------------------------

    def run(self) -> dict:
        t_start = time.time()
        # faultless references (b = 0, adversary-free), one per rule
        self._run_round([(rule, "none", 0) for rule in self.rules])
        for rule in self.rules:
            self.refs[rule] = self.probes[(rule, "none", 0)]
            self.refs[rule]["survived"] = True
        pairs = [(r, a) for r in self.rules for a in self.adversaries]
        # the raw search answer per pair, before the prefix certificate
        search_bstar: dict[tuple[str, str], int] = {}
        if self.config.mode == "ladder":
            self._run_round([(r, a, b) for r, a in pairs
                             for b in range(1, self.feasible[r] + 1)])
        elif self.config.mode == "bisect":
            # batched binary search: one engine round serves every pair's probe
            lo = {p: 0 for p in pairs}  # largest b known surviving
            hi = {p: self.feasible[p[0]] + 1 for p in pairs}  # smallest diverging
            while any(hi[p] - lo[p] > 1 for p in pairs):
                mids = {p: (lo[p] + hi[p]) // 2 for p in pairs if hi[p] - lo[p] > 1}
                self._run_round([(r, a, m) for (r, a), m in mids.items()])
                for p, mid in mids.items():
                    if self._survived(p[0], p[1], mid):
                        lo[p] = mid
                    else:
                        hi[p] = mid
            search_bstar = dict(lo)
            # monotone certificate: probe the skipped prefix below each b*
            self._run_round([(r, a, b) for (r, a) in pairs
                             for b in range(1, lo[(r, a)] + 1)])
        else:
            raise ValueError(f"unknown breakdown mode {self.config.mode!r}")

        result = {"rules": {}, "meta": {
            "mode": self.config.mode, "seeds": list(self.config.seeds),
            "loss_ratio": self.config.loss_ratio,
            "adversaries": list(self.adversaries),
            "scenario": self.scenario,
            "trust": self.trust is not None,
        }}
        for rule in self.rules:
            rrec = {"feasible_b": self.feasible[rule],
                    "ref": dict(self.refs[rule]), "adversaries": {}}
            worst = self.feasible[rule]
            for adv in self.adversaries:
                # the full probed ladder, failures included
                ladder = {}
                for b in range(1, self.feasible[rule] + 1):
                    if (rule, adv, b) in self.probes:
                        self._survived(rule, adv, b)
                        ladder[b] = dict(self.probes[(rule, adv, b)])
                bstar = 0
                for b in range(1, self.feasible[rule] + 1):
                    if b not in ladder or not ladder[b]["survived"]:
                        break
                    bstar = b
                # every b <= b* probed and survived, and the prefix walk
                # agrees with the raw search answer
                certified = all(
                    b in ladder and ladder[b]["survived"]
                    for b in range(1, bstar + 1)
                ) and bstar == search_bstar.get((rule, adv), bstar)
                rrec["adversaries"][adv] = {
                    "bstar": bstar,  # the longest all-surviving prefix
                    "certified_monotone": bool(certified),
                    "probes": {str(b): rec for b, rec in ladder.items()},
                }
                worst = min(worst, bstar)
            rrec["bstar_worst_adversary"] = worst
            result["rules"][rule] = rrec
        result["meta"].update({
            "wall_s": time.time() - t_start,
            "compiles": self.compiles,
            "cells_run": self.cells_run,
            "cells_per_sec": self.cells_run / max(time.time() - t_start, 1e-9),
        })
        if self.config.measure_compile:
            result["meta"]["compile_s"] = self.compile_s
            result["meta"]["steady_state_s"] = self.steady_state_s
        return result


def breakdown_curve(result: dict) -> list[tuple[str, str, int, float, float | None]]:
    """Flatten a certification result into figure rows:
    ``(rule, adversary, b, final_loss, score)`` sorted for plotting."""
    rows = []
    for rule, rrec in result["rules"].items():
        for adv, arec in rrec["adversaries"].items():
            for b_str, probe in sorted(arec["probes"].items(), key=lambda kv: int(kv[0])):
                rows.append((rule, adv, int(b_str),
                             probe["final_loss"], probe.get("score")))
    return rows
