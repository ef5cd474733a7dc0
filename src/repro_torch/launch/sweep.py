"""The batched experiment sweep — port of `repro.launch.sweep --mode grid`:
the rule x attack x b x seed (x network scenario x codec x adversary)
matrix on the paper's
MNIST-like linear task through the grid engine (`repro_torch.sim`), every
pending cell in one engine run on the card, resumable from the per-cell
store (one JSON a cell, keyed by the reference's `Cell.tag`, so a store
written by either package resumes in the other):

    PYTHONPATH=src python -m repro_torch.launch.sweep --mode grid \\
        --out experiments/grid [--rules trimmed_mean,median] \\
        [--attacks random,alie] [--byz 1,2] [--seeds 0,1,2,3] \\
        [--scenarios ideal,lossy] [--codecs identity,int8] \\
        [--adversaries none,inner_max] [--grid-ticks 60] \\
        [--grid-chunk 16] [--sparse] [--metrics DIR] [--metrics-capacity 64] \\
        [--trace DIR] [--profile DIR] [--device cpu]

``--scenarios`` names `repro_torch.net.scenarios` entries: every cell then
runs through the network runtime (`GridNetRuntime`, schedules of
``--grid-ticks`` ticks); ``sync`` (the default) is the broadcast path.
``--codecs`` names wire codecs (`repro_torch.comm.codec`) and
``--adversaries`` `repro_torch.adversary` entries, two more grid axes.  It
writes the per-cell records and ``GridResult.json`` (the whole store) with
each cell's honest test accuracy.

The observability flags of grid mode: ``--metrics DIR`` runs every cell
with the live metric ring (``--metrics-capacity`` slots, bit-inert) and
streams each cell's rows, tagged by cell, to ``DIR/metrics.jsonl`` through
a writer that raises ``obs.alert`` events (watch with ``python -m
repro_torch.obs.monitor DIR``); ``--trace DIR`` runs every cell with the
trace's forensics (bit-inert) and writes ``DIR/obs_summary.json``, each
cell's forensic summary (render with ``python -m repro_torch.obs.report
DIR``); either writes ``manifest.json`` at the run's start and end and the
run's events to ``events.jsonl``; ``--profile DIR`` records the engine run
under `torch.profiler` (the ``bridge.*`` and ``kernels.*`` ranges) and
writes its Chrome trace to ``DIR/profile.trace.json``.

``--mode breakdown`` certifies b* per (rule, adversary) on the MNIST-like
linear task with the extreme non-iid partition
(`repro_torch.adversary.breakdown`), writing ``BENCH_breakdown.json``
under ``--out`` (default ``experiments/breakdown``):

    PYTHONPATH=src python -m repro_torch.launch.sweep --mode breakdown \
        [--rules trimmed_mean,median] [--adversaries random,alie,ipm,inner_max] \
        [--breakdown-mode ladder|bisect] [--breakdown-b-max 3] \
        [--breakdown-scenario lossy] [--trace DIR] [--device cpu]

``--trace DIR`` writes the run's events to ``DIR/events.jsonl``.

``--mode net`` is the reference's subprocess fan-out over the scenario
matrix: one ``python -m repro_torch.launch.train --net`` job a (rule,
attack, scenario) of `NET_SCENARIOS` (the reduced ``--net-arch``, 6 nodes,
``--net-steps`` steps), ``--jobs`` at a time, a JSON record each under
``--out`` (default ``experiments/net``; a record already there is not run
again):

    PYTHONPATH=src python -m repro_torch.launch.sweep --mode net --out /tmp/netsweep \
        --rules trimmed_mean --attacks alie --scenarios ideal,lossy --net-steps 10

``--trust`` (with ``--trust-evict`` and ``--trust-warmup``) runs every cell
with the trust layer (`repro_torch.trust.TrustSpec`), in grid and in
breakdown mode; breakdown with ``--trust`` runs on the complete graph (the
echo's quorums need gossip triangles), as the reference does.  The
reference's ``--mode dryrun`` (the lowering matrix over TPU meshes) stays
with the JAX package and raises.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch import prng
from repro_torch.core.bridge import replicate
from repro_torch.core.graph import complete_graph
from repro_torch.data.mnist_like import make_mnist_like
from repro_torch.data.partition import device_node_batches, partition_iid
from repro_torch.device import resolve_device, wait
from repro_torch.models import small
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.events import EventLog
from repro_torch.obs.manifest import write_manifest
from repro_torch.sim import ExperimentGrid, GridEngine, default_topology
from repro_torch.sim import results as results_lib


def _refuse_unported(args) -> None:
    """The reference's mode that belongs to the JAX package."""
    if args.mode == "dryrun":
        raise ValueError("--mode dryrun: the lowering matrix over TPU meshes belongs to the "
                         "JAX package (ROADMAP Queue 1, the sharded path and the lowering "
                         "matrix); the port's sweep runs --mode grid, net and breakdown")


# The network-condition axis of the scenario matrix (--mode net), each
# scenario the `repro_torch.launch.train --net` flags of the reference's.
NET_SCENARIOS = {
    "ideal": ["--net"],
    "lossy": ["--net", "--net-drop", "0.2"],
    "laggy": ["--net", "--net-latency", "3"],
    "lossy_laggy": ["--net", "--net-drop", "0.2", "--net-latency", "3"],
    "bandwidth64": ["--net", "--net-cap", "64"],
    "churn": ["--net", "--net-schedule", "churn", "--net-churn-prob", "0.3"],
    "partition": ["--net", "--net-schedule", "partition"],
}

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_net_job(rule, attack, scenario, out_dir, timeout, arch, steps,
                device: str = "cuda") -> tuple[str, str]:
    """One ``python -m repro_torch.launch.train --net`` subprocess of the
    scenario matrix (the reference's job: the reduced ``arch``, 6 nodes, b
    = 1, batch 2, sequence 32, ``steps`` steps), its record written to
    ``out_dir/net_<rule>_<attack>_<scenario>.json``; a cached record is not
    run again.  Returns ``(tag, status)``."""
    tag = f"net_{rule}_{attack}_{scenario}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path):
        return tag, "cached"
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", arch, "--reduce", "--nodes", "6", "--byzantine", "1",
           "--rule", rule, "--attack", attack, "--steps", str(steps),
           "--batch", "2", "--seq", "32", "--log-every", str(steps),
           "--device", device] + NET_SCENARIOS[scenario]
    path_var = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": _SRC + (os.pathsep + path_var if path_var else "")}
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
        status = "ok" if proc.returncode == 0 else "failed"
        with open(path, "w") as f:
            json.dump({"rule": rule, "attack": attack, "scenario": scenario,
                       "status": status, "stdout": proc.stdout[-3000:],
                       "stderr": proc.stderr[-3000:] if status == "failed" else ""},
                      f, indent=2)
        return tag, f"{status.upper() if status != 'ok' else status} ({time.time()-t0:.0f}s)"
    except subprocess.TimeoutExpired:
        with open(path, "w") as f:
            json.dump({"rule": rule, "attack": attack, "scenario": scenario,
                       "status": "timeout"}, f, indent=2)
        return tag, "TIMEOUT"


def run_net_mode(args) -> list[tuple[str, str]]:
    """The rule x attack x scenario matrix, one `run_net_job` each,
    ``--jobs`` at a time; returns each job's ``(tag, status)``."""
    jobs = [(r, a, s) for r in args.rules.split(",") for a in args.attacks.split(",")
            for s in args.scenarios.split(",")]
    print(f"{len(jobs)} net-scenario jobs -> {args.out}")
    done = []
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = [ex.submit(run_net_job, r, a, s, args.out, args.timeout, args.net_arch,
                          args.net_steps, args.device) for r, a, s in jobs]
        for fut in futs:
            tag, status = fut.result()
            print(f"  {tag:60s} {status}", flush=True)
            done.append((tag, status))
    return done


def _trust_spec(args):
    """The `repro_torch.trust.TrustSpec` the --trust flags describe (None
    when --trust is off: the trust-free step)."""
    if not args.trust:
        return None
    from repro_torch.trust import TrustSpec

    return TrustSpec(evict_threshold=args.trust_evict, warmup=args.trust_warmup)


def run_grid_mode(args) -> results_lib.GridResult | None:
    """The batched sweep over rule x attack x b x seed (x scenario) on the
    MNIST-like linear task, resuming from the per-cell store; returns this
    run's result (None when every cell was cached)."""
    dev = resolve_device(args.device)
    rules = args.rules.split(",")
    attacks = args.attacks.split(",")
    byz = [int(x) for x in args.byz.split(",")]
    seeds = [int(x) for x in args.seeds.split(",")]
    scenarios = None
    if args.scenarios not in ("sync", "none", ""):
        scenarios = args.scenarios.split(",")
    codecs = args.codecs.split(",")
    adversaries = args.adversaries.split(",") if args.adversaries else ["none"]
    m, ticks = args.grid_nodes, args.grid_ticks
    topo = default_topology(m, rules, byz, seed=0)
    grid = ExperimentGrid(topo, rules, attacks, byz, seeds, scenarios=scenarios, codecs=codecs,
                          adversaries=adversaries, lam=1.0, t0=30.0)
    done = results_lib.existing_tags(args.out)
    pending = [c for c in grid.cells() if c.tag not in done]
    print(f"{grid.num_cells} grid cells ({len(done & {c.tag for c in grid.cells()})} cached) "
          f"-> {args.out}")
    if not pending:
        return None
    x, y, xt, yt = make_mnist_like(args.grid_train, args.grid_test, seed=0)
    shards = partition_iid(x, y, m, seed=0)
    batches = device_node_batches(shards, args.grid_batch, seed=0, device=dev).stacked(ticks)

    def init_fn(seed):
        key = prng.PRNGKey(seed)
        return replicate(small.init_linear(key, device=dev), m, perturb=0.01, key=key)

    run_dir = args.trace or args.metrics
    events = trace_spec = metric_spec = writer = None
    if run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        write_manifest(run_dir, kind="sweep-grid", config=vars(args))
        events = EventLog(os.path.join(run_dir, "events.jsonl"))
    if args.trace is not None:
        trace_spec = obs_trace.TraceSpec()
    if args.metrics is not None:
        metric_spec = obs_metrics.MetricSpec(capacity=args.metrics_capacity)
        writer = obs_metrics.MetricWriter(os.path.join(args.metrics, "metrics.jsonl"),
                                          alerts=obs_metrics.AlertRules(), events=events)
    engine = GridEngine(grid, small.linear_loss_and_grad, cells=pending,
                        num_ticks=ticks if scenarios else None, sparse=args.sparse,
                        trace=trace_spec, trust=_trust_spec(args), metrics=metric_spec,
                        events=events, device=dev)
    prof = contextlib.nullcontext()
    if args.profile is not None:
        os.makedirs(args.profile, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    t0 = time.time()
    with prof:
        state = engine.init(init_fn)
        state, metrics = engine.run(state, batches, chunk=args.grid_chunk, metric_writer=writer)
        wait(dev)
    wall = time.time() - t0
    if writer is not None:
        writer.close()
        print(f"metric stream -> {writer.path}  (watch: python -m repro_torch.obs.monitor "
              f"{args.metrics})")
    if args.profile is not None:
        path = os.path.join(args.profile, "profile.trace.json")
        prof.export_chrome_trace(path)
        if events is not None:
            events.emit("profile.capture", dir=args.profile)
        print(f"profiler trace -> {path}")
    result = results_lib.collect(pending, metrics, meta={
        "num_nodes": m, "ticks": ticks, "wall_s": wall,
        "cells_per_sec": len(pending) / wall, "us_per_cell": wall / len(pending) * 1e6,
        "steps_built": engine.num_steps_built, "step_calls": engine.step_calls,
        "chunk": args.grid_chunk, "rules": engine.rule_bank, "attacks": engine.attack_bank,
        "scenarios": engine.scenario_bank, "codecs": engine.codec_bank,
        "adversaries": engine.adversary_bank, "device": str(dev),
    })
    # per-cell honest test accuracy (the paper's metric)
    xt, yt = torch.as_tensor(xt, device=dev), torch.as_tensor(yt, device=dev)
    for i, rec in enumerate(result.cells):
        hm = ~engine.byz_masks[i]
        accs = [float(small.linear_accuracy({k: v[i, j] for k, v in state.params.items()},
                                            xt, yt))
                for j in hm.nonzero()[0]]
        rec["accuracy"] = float(sum(accs) / max(len(accs), 1))
    if events is not None:
        events.close()
    if run_dir is not None:
        write_manifest(run_dir, extra={"ended": True, "wall_s": wall, "cells": len(pending)})
    if trace_spec is not None:
        senders = engine.sender_grid()
        cells_out = []
        for i, c in enumerate(pending):
            one = obs_trace.TraceState(*(x[i] for x in state.obs))
            cells_out.append({"tag": c.tag, "rule": c.rule,
                              **obs_trace.summarize(trace_spec, one, byz_mask=engine.byz_masks[i],
                                                    senders=senders)})
        summary_path = os.path.join(args.trace, "obs_summary.json")
        with open(summary_path, "w") as f:
            json.dump({"meta": {"mode": "grid", "num_nodes": m, "ticks": ticks},
                       "cells": cells_out}, f, indent=2, sort_keys=True)
        print(f"obs summary -> {summary_path}  (render: python -m repro_torch.obs.report "
              f"{args.trace})")
    result.save_cells(args.out)
    # the aggregate covers the whole store (earlier runs' cells included)
    full = results_lib.load_cell_store(args.out)
    full.meta.update(result.meta)
    full.meta["computed_this_run"] = len(pending)
    full.save(os.path.join(args.out, "GridResult.json"))
    print(f"{len(pending)} cells in {wall:.1f}s ({result.meta['cells_per_sec']:.2f} cells/s, "
          f"{engine.num_steps_built} step(s) built, {engine.step_calls} group steps)")
    for rec, row in zip(result.cells, result.rows(), strict=True):
        print(f"  {row[0]:60s} acc={rec['accuracy']:.4f} loss={rec['final_loss']:.4f}")
    return result


def run_breakdown_mode(args) -> dict:
    """Breakdown-point certification on the MNIST-like linear task (extreme
    non-iid partition: consensus is required for honest test accuracy,
    which is what adaptive adversaries break); returns the result written
    to ``BENCH_breakdown.json``."""
    from repro_torch.adversary.breakdown import BreakdownConfig, BreakdownEngine
    from repro_torch.obs import EventLog
    from repro_torch.sim.tasks import linear_task

    dev = resolve_device(args.device)
    rules = args.rules.split(",")
    adversaries = (args.adversaries or "random,alie,ipm,inner_max").split(",")
    m, ticks = args.grid_nodes, args.grid_ticks
    if args.trust:
        # echo quorums need gossip triangles: a sender's witnesses must be
        # adjacent to the receiver, so trust runs take the complete graph
        topo = complete_graph(m, max(args.breakdown_b_max, 1))
    else:
        # the topology must admit the whole probed ladder, not just b = 1
        topo = default_topology(m, rules, [max(args.breakdown_b_max, 1)], seed=0)
    task = linear_task(m, ticks, batch=args.grid_batch, num_train=args.grid_train,
                       num_test=args.grid_test, seed=0, device=dev)
    events = None
    if args.trace is not None:
        os.makedirs(args.trace, exist_ok=True)
        events = EventLog(os.path.join(args.trace, "events.jsonl"))
    try:
        engine = BreakdownEngine(
            topo, rules, adversaries, task.grad_fn, task.init_fn, task.batches,
            lam=1.0, t0=30.0,
            config=BreakdownConfig(mode=args.breakdown_mode,
                                   seeds=tuple(int(s) for s in args.seeds.split(",")),
                                   b_max=args.breakdown_b_max,
                                   loss_ratio=args.breakdown_loss_ratio,
                                   score_drop=args.breakdown_score_drop),
            eval_fn=task.eval_accuracy, engine_chunk=args.grid_chunk,
            trust=_trust_spec(args), scenario=args.breakdown_scenario, events=events,
            device=dev)
        result = engine.run()
    finally:
        if events is not None:
            events.close()
    path = os.path.join(args.out, "BENCH_breakdown.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)
    print(f"breakdown certification ({result['meta']['cells_run']} cells, "
          f"{result['meta']['compiles']} steps built, "
          f"{result['meta']['wall_s']:.1f}s) -> {path}")
    for rule, rrec in result["rules"].items():
        stars = "  ".join(f"{a}:b*={arec['bstar']}"
                          for a, arec in rrec["adversaries"].items())
        print(f"  {rule:14s} feasible_b={rrec['feasible_b']}  {stars}  "
              f"worst={rrec['bstar_worst_adversary']}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="grid", choices=["dryrun", "net", "grid", "breakdown"])
    ap.add_argument("--out", default=None,
                    help="default experiments/grid (grid mode), experiments/breakdown")
    ap.add_argument("--rules", default="trimmed_mean,median")
    # None: the defaults differ by mode (net sweeps every scenario)
    ap.add_argument("--attacks", default=None,
                    help="default random,alie (grid, breakdown) / random,alie,"
                         "selective_victim (net)")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated net scenarios (repro_torch.net.scenarios), or sync "
                         "(the broadcast path; the grid's default); net mode: of "
                         f"{','.join(NET_SCENARIOS)} (default all)")
    # --mode net: the subprocess fan-out over repro_torch.launch.train
    ap.add_argument("--jobs", type=int, default=4, help="net mode: subprocesses at a time")
    ap.add_argument("--timeout", type=int, default=1500, help="net mode: seconds a job")
    ap.add_argument("--net-arch", default="qwen3-4b", help="net mode: the reduced arch")
    ap.add_argument("--net-steps", type=int, default=30, help="net mode: steps a job")
    ap.add_argument("--byz", default="1", help="comma-separated Byzantine counts")
    ap.add_argument("--seeds", default="0", help="comma-separated seeds")
    ap.add_argument("--codecs", default="identity",
                    help="comma-separated wire codecs (repro_torch.comm.codec), a grid axis")
    ap.add_argument("--adversaries", default=None,
                    help="comma-separated repro_torch.adversary names: a grid axis (grid "
                         "mode; default none) and the certified suite (breakdown mode; "
                         "default random,alie,ipm,inner_max)")
    ap.add_argument("--breakdown-mode", default="ladder", choices=["ladder", "bisect"])
    ap.add_argument("--breakdown-b-max", type=int, default=3,
                    help="largest b probed (capped by each rule's feasible b)")
    ap.add_argument("--breakdown-loss-ratio", type=float, default=4.0,
                    help="a probe diverges above this multiple of the b = 0 reference's "
                         "final loss")
    ap.add_argument("--breakdown-score-drop", type=float, default=0.15,
                    help="a probe diverges when its honest accuracy falls this far below "
                         "the reference's")
    ap.add_argument("--breakdown-scenario", default=None,
                    help="run the probes through the net runtime on this "
                         "repro_torch.net.scenarios entry")
    ap.add_argument("--grid-nodes", type=int, default=12)
    ap.add_argument("--grid-ticks", type=int, default=60)
    ap.add_argument("--grid-batch", type=int, default=32)
    ap.add_argument("--grid-train", type=int, default=2000)
    ap.add_argument("--grid-test", type=int, default=400)
    ap.add_argument("--grid-chunk", type=int, default=None,
                    help="max experiments a group runs at once (memory bound); default "
                         "runs each group whole")
    ap.add_argument("--sparse", action="store_true",
                    help="neighbor-indexed [M, K] layout (the gather kernels)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="grid mode: run every cell with the trace's forensics (bit-inert) "
                         "and write DIR/events.jsonl, DIR/manifest.json and "
                         "DIR/obs_summary.json (python -m repro_torch.obs.report DIR); "
                         "breakdown mode: write the run's events to DIR/events.jsonl")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="grid mode: record the engine run under torch.profiler and write "
                         "its Chrome trace to DIR/profile.trace.json")
    ap.add_argument("--metrics", default=None, metavar="DIR",
                    help="grid mode: run every cell with the live metric ring (bit-inert) and "
                         "stream its rows, tagged by cell, to DIR/metrics.jsonl "
                         "(python -m repro_torch.obs.monitor DIR)")
    ap.add_argument("--metrics-capacity", type=int, default=64,
                    help="metric ring slots a cell; a grid streams each cell's last "
                         "`capacity` ticks")
    # the trust layer (repro_torch.trust; grid and breakdown modes)
    ap.add_argument("--trust", action="store_true",
                    help="run every cell with reputation-weighted screening and eviction "
                         "(repro_torch.trust); pair with the rep_* rules for the weights")
    ap.add_argument("--trust-evict", type=float, default=0.5,
                    help="the suspicion above which an edge is evicted")
    ap.add_argument("--trust-warmup", type=int, default=8,
                    help="ticks before an eviction can latch")
    args = ap.parse_args(argv)
    _refuse_unported(args)
    if args.out is None:
        args.out = {"grid": "experiments/grid", "breakdown": "experiments/breakdown",
                    "net": "experiments/net"}[args.mode]
    os.makedirs(args.out, exist_ok=True)
    if args.mode == "net":
        args.scenarios = args.scenarios or ",".join(NET_SCENARIOS)
        args.attacks = args.attacks or "random,alie,selective_victim"
        return run_net_mode(args)
    args.scenarios = "sync" if args.scenarios is None else args.scenarios
    args.attacks = args.attacks or "random,alie"
    if args.mode == "breakdown":
        return run_breakdown_mode(args)
    return run_grid_mode(args)


if __name__ == "__main__":
    main()
