"""Honest-node test accuracies of the JAX package (the reference) on the
CPU, at the settings `chip_smoke.py` trains the PyTorch port at: the
thresholds the port's card runs are held to (within 0.01 of each).

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tools/reference_accuracy.py \
        [--only dense,sparse,variants,wire,wire_sparse,variants_wire,net,net_kb,adversary,
                breakdown,trust,sweep_obs]

Configurations (each as `chip_smoke.py` runs it, same seeds and batches):

* ``dense``: the MNIST-like linear task, iid partition of 6000 samples,
  batch 32, M = 50 on ``erdos_renyi(50, 0.5, 4)``, b = 4, random attack,
  t0 = 30, init seed 0, key seed 1: BRIDGE-K and BRIDGE-B for 200 ticks;
  geomedian, clipped_mean, rep_trimmed_mean and rep_median for 20;
* ``sparse``: iid partition of 16384 samples, batch 8, M = 512 on
  ``small_world(512, 8, 2, rewire_prob=0.2)``, the sparse layout, b = 2,
  t0 = 100: BRIDGE-K and BRIDGE-B for 200 ticks;
* ``variants``: `examples/bridge_variants.py` at its defaults (M = 20,
  b = 2, random attack, 120 steps; ByRDiE 2 sweeps, BRDSO 120 steps)
  through `benchmarks.common`;
* ``wire``: BRIDGE-T at the ``dense`` settings for 200 ticks with a codec
  and a wire attack: int8 under ``scale_abuse`` and ``garbage_codeword``,
  the identity codec under ``garbage_codeword``, int4 and ``topk50_int8``
  under ``random``;
* ``wire_sparse``: BRIDGE-T at the ``sparse`` settings on
  ``small_world(512, 6, 2, rewire_prob=0.2)``, int8 under ``scale_abuse``;
* ``variants_wire``: the variants at their defaults under
  ``--codec int4 --attack scale_abuse`` (each rule uncompressed and int4;
  the baselines' row is ``variants``' own, under ``random``);
* ``net``: asynchronous BRIDGE-T through `repro.net.AsyncBridgeTrainer`'s
  ``run_scan`` over stacked batches, with the mean ``delivered_frac`` and
  ``mean_staleness`` of each run beside its accuracy:
  - the net benchmark's settings (``benchmarks/net_bench.py``): M = 20 on
    ``erdos_renyi(20, 0.5, 2)``, b = 2, ``alie``, t0 = 30, iid partition
    of 4000 samples, batch 32, init seed 0, key seed 0, 120 ticks, under
    every ``NET_SCENARIOS`` entry (its channel, staleness bound and
    schedule kind on this graph), and ``selective_victim`` under ``lossy``;
  - the ``dense`` settings (random attack, b = 4) for 100 ticks under
    ``lossy_laggy`` and ``narrowband64k``, each with the identity and the
    per-link int8 codec;
  - the scale benchmark's sparse settings (``benchmarks/scale_bench.py``):
    ``small_world(512, 6, 1, rewire_prob=0.2)``, b = 1, ``alie``, drop
    0.05, staleness bound 2, t0 = 100, iid partition of 16384 samples,
    batch 8, init and key seed 0, 200 ticks, the sparse layout.
  It took 5 minutes on an 8-core CPU.
* ``net_kb``: asynchronous BRIDGE-K and BRIDGE-B at the net benchmark's
  settings on ``erdos_renyi(20, 0.9, 1)`` (whose in-degrees meet Bulyan's
  Table-II minimum of 6 at b = 1), b = 1, ``alie``, t0 = 30, iid partition
  of 4000 samples, batch 32, init and key seed 0, 120 ticks, under
  ``ideal`` and ``lossy``; and asynchronous BRIDGE-K at the scale
  benchmark's sparse settings (as ``net``'s sparse run: ``small_world(512,
  6, 1, rewire_prob=0.2)``, b = 1, ``alie``, drop 0.05, staleness bound 2,
  t0 = 100, iid partition of 16384 samples, batch 8, init and key seed 0,
  the sparse layout) for 20 ticks.
* ``adversary``: the breakdown benchmark's task (``benchmarks/
  breakdown_bench.py``): M = 10, the extreme non-iid partition of 4000
  samples (800 test), batch 32, 60 ticks, t0 = 30, init and key seed 0,
  ``default_topology(10, (trimmed_mean, median), (3,))``; BRIDGE-T and
  BRIDGE-M under each of ``random``, ``alie`` (as stateless adversaries),
  ``ipm``, ``alie_online``, ``dissensus``, ``inner_max``, ``equivocate``
  and ``slander`` at b = 1, 2, 3 (each cell's own `BridgeTrainer`, its
  Byzantine mask drawn with seed 0, as the grid's cells); BRIDGE-K and
  BRIDGE-B under ``inner_max`` at M = 20, b = 2 on ``default_topology(20,
  (krum, bulyan), (2,))``, the same task at M = 20; asynchronous BRIDGE-T
  at M = 20, b = 2 under ``lossy_laggy`` with ``dissensus`` and
  ``equivocate`` (the message forms) on ``default_topology(20,
  (trimmed_mean,), (2,))``; and asynchronous BRIDGE-T with ``inner_max``
  under ``lossy`` at the scale benchmark's sparse settings (as ``net``'s
  sparse run, the schedule of ``lossy``) for 20 ticks, and BRIDGE-M there.
* ``breakdown``: certification and the red-team search, not accuracies:
  - ``benchmarks/breakdown_bench.py``'s ``run_certification`` at its
    defaults (M = 10, extreme non-iid, 4000 / 800 samples, 60 ticks,
    BRIDGE-T / M x ``random``, ``alie``, ``ipm``, ``inner_max``, b_max 3,
    the ladder, score_drop 0.25, loss_ratio 50): each rule's ``feasible_b``
    and reference probe, each pair's b* and ``certified_monotone``, each
    probe's ``survived``, ``final_loss`` and ``score``;
  - a certification through the net grids: the same task at 30 ticks,
    ``lossy``, BRIDGE-T x ``alie_online``, b_max 2;
  - the divergence sentinel on ``tests/test_adversary.py``'s quadratic
    task made unstable (``tests/test_obs.py``: M = 10, D = 4, 12 ticks,
    ``erdos_renyi(10, 0.8, 2, seed=1)``, t0 = 10, the gradient times
    1e4): BRIDGE-T x ``random``, b_max 2, each probe's ``first_bad_tick``;
  - ``repro.adversary.search``'s CLI defaults (BRIDGE-T, ``ipm``, b = 2,
    M = 10, 40 ticks, population 12, 4 generations): generation 0's
    fitness of each proposal (the registered default, then 11 draws of
    ``default_rng(0)``), and the search's ``best_fitness`` and
    ``default_fitness``.

* ``trust``: the trust layer and the trace's forensics, not accuracies:
  - ``benchmarks/trust_bench.py``'s three measurements at its smoke sizes:
    the breakdown study (M = 15, complete graph, moderate non-iid, 2000 /
    400 samples, 64 ticks, ``equivocate`` through ``ideal``, b_max 7,
    score_drop 0.15, loss_ratio 50: static BRIDGE-T against
    ``rep_trimmed_mean`` with ``TrustSpec(warmup=4)``), each arm's b*,
    feasible b, every probe's ``survived`` and ``score``; the detection
    cells (M = 12, the d = 64 quadratic, 16 ticks, b = 2, ``equivocate``
    and ``slander`` through ``ideal``), each cell's trust summary; the
    inertness check (M = 32, 12 ticks), whether trust on but inert is bit
    for bit trust off;
  - ``benchmarks/obs_bench.py``'s ``trace_overhead`` cells at M = 512
    (``small_world(512, 6, 2)``, BRIDGE-T, ``alie``, drop 0.05, staleness
    bound 2, t0 = 100, the sparse runtime): the d = 64 quadratic over 20
    ticks with ``decide_stride`` 4 and the MNIST-like linear task (d =
    7850) over 3 ticks with stride 16; each one's bit-identity, AUC and
    survival rates.
* ``sweep_obs``: ``python -m repro.launch.sweep --mode grid --trace DIR`` at
  grid_bench's grid (``SWEEP_OBS_ARGS``: BRIDGE-T and BRIDGE-M under
  ``random``, ``alie`` and ``sign_flip``, b = 2, seeds 0-7, M = 12, 30
  ticks, 4000 / 800 samples), each cell's AUC in ``obs_summary.json``.

Prints one line per configuration and a JSON object of all of them last.
Takes some minutes (the sparse runs most of it).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import jax
import numpy as np

from repro.core import bridge, graph
from repro.sim import tasks


def run_bridge(task, topo, rule, *, b, t0, ticks, sparse=False, attack="random",
               codec="identity"):
    cfg = bridge.BridgeConfig(topology=topo, rule=rule, num_byzantine=b, attack=attack, t0=t0,
                              sparse=sparse, codec=codec)
    trainer = bridge.BridgeTrainer(cfg, task.grad_fn)
    state = trainer.init(task.init_fn(0), seed=1)
    for i in range(ticks):  # a fresh task per configuration: batches 0..ticks-1 of one stream
        state, _ = trainer.step(state, jax.tree_util.tree_map(jax.numpy.asarray, task.batch_fn(i)))
    return task.eval_accuracy(state.params, trainer.honest_mask)


def dense():
    topo = graph.erdos_renyi(50, 0.5, 4, seed=0)
    out = {}
    for rule, ticks in (("krum", 200), ("bulyan", 200), ("geomedian", 20), ("clipped_mean", 20),
                        ("rep_trimmed_mean", 20), ("rep_median", 20)):
        task = tasks.linear_task(50, 0, partition="iid", num_train=6000, num_test=1000, batch=32)
        out[f"dense {rule} {ticks}"] = run_bridge(task, topo, rule, b=4, t0=30, ticks=ticks)
    return out


def sparse():
    topo = graph.small_world(512, 8, 2, rewire_prob=0.2, seed=0)
    out = {}
    for rule in ("krum", "bulyan"):
        task = tasks.linear_task(512, 0, partition="iid", num_train=16384, num_test=1000, batch=8)
        out[f"sparse {rule} 200"] = run_bridge(task, topo, rule, b=2, t0=100, ticks=200,
                                               sparse=True)
    return out


def variants():
    from benchmarks.common import run_brdso, run_byrdie, run_decentralized

    out = {}
    for rule in ("mean", "trimmed_mean", "median", "krum", "bulyan"):
        out[f"variants {rule}"] = run_decentralized(model="linear", rule=rule, attack="random",
                                                    num_nodes=20, num_byzantine=2,
                                                    steps=120)["accuracy"]
    out["variants byrdie"] = run_byrdie(num_nodes=20, num_byzantine=2, attack="random",
                                        sweeps=2)["accuracy"]
    out["variants brdso"] = run_brdso(num_nodes=20, num_byzantine=2, attack="random",
                                      steps=120)["accuracy"]
    return out


WIRE_RUNS = (("int8", "scale_abuse"), ("int8", "garbage_codeword"),
             ("identity", "garbage_codeword"), ("int4", "random"), ("topk50_int8", "random"))


def wire():
    topo = graph.erdos_renyi(50, 0.5, 4, seed=0)
    out = {}
    for codec, attack in WIRE_RUNS:
        task = tasks.linear_task(50, 0, partition="iid", num_train=6000, num_test=1000, batch=32)
        out[f"wire {codec} {attack}"] = run_bridge(task, topo, "trimmed_mean", b=4, t0=30,
                                                   ticks=200, attack=attack, codec=codec)
    return out


def wire_sparse():
    topo = graph.small_world(512, 6, 2, rewire_prob=0.2, seed=0)
    task = tasks.linear_task(512, 0, partition="iid", num_train=16384, num_test=1000, batch=8)
    return {"wire sparse int8 scale_abuse": run_bridge(task, topo, "trimmed_mean", b=2, t0=100,
                                                       ticks=200, sparse=True,
                                                       attack="scale_abuse", codec="int8")}


def variants_wire():
    from benchmarks.common import run_decentralized

    out = {}
    for rule in ("mean", "trimmed_mean", "median", "krum", "bulyan"):
        for codec in ("identity", "int4"):
            out[f"variants {rule} {codec} scale_abuse"] = run_decentralized(
                model="linear", rule=rule, attack="scale_abuse", codec=codec, num_nodes=20,
                num_byzantine=2, steps=120)["accuracy"]
    return out


def run_async(task, topo, *, b, t0, ticks, attack, seed=0, init_seed=0, codec="identity",
              sparse=False, scenario="ideal", channel=None, staleness=None,
              rule="trimmed_mean", adversary="none"):
    from repro.net import AsyncBridgeConfig, AsyncBridgeTrainer
    from repro.net.dynamic import scenario_schedule
    from repro.net.scenarios import get_scenario

    spec = get_scenario(scenario)
    cfg = AsyncBridgeConfig(
        topology=topo, rule=rule, num_byzantine=b, attack=attack, lam=1.0, t0=t0,
        adversary=adversary, codec=codec, sparse=sparse,
        channel=spec.channel if channel is None else channel,
        staleness_bound=spec.staleness_bound if staleness is None else staleness,
        schedule=scenario_schedule(spec.schedule_kind, topo, ticks, seed=0,
                                   churn_prob=spec.churn_prob))
    trainer = AsyncBridgeTrainer(cfg, task.grad_fn)
    state = trainer.init(task.init_fn(init_seed), seed=seed)
    state, ms = trainer.run_scan(state, bridge.stack_batches(task.batch_fn, ticks))
    return {"accuracy": task.eval_accuracy(state.params, trainer.honest_mask),
            "delivered_frac": float(np.mean(np.asarray(ms["delivered_frac"]))),
            "mean_staleness": float(np.mean(np.asarray(ms["mean_staleness"])))}


def net():
    from repro.net.channel import ChannelConfig
    from repro.net.scenarios import NET_SCENARIOS

    out = {}
    topo = graph.erdos_renyi(20, 0.5, 2, seed=0)
    runs = [(name, "alie") for name in NET_SCENARIOS] + [("lossy", "selective_victim")]
    for name, attack in runs:
        task = tasks.linear_task(20, 0, partition="iid", num_train=4000, num_test=800, batch=32)
        tag = f"net {name}" + ("" if attack == "alie" else f" {attack}")
        out[tag] = run_async(task, topo, b=2, t0=30, ticks=120, attack=attack, scenario=name)
    topo = graph.erdos_renyi(50, 0.5, 4, seed=0)
    for name in ("lossy_laggy", "narrowband64k"):
        for codec in ("identity", "int8"):
            task = tasks.linear_task(50, 0, partition="iid", num_train=6000, num_test=1000,
                                     batch=32)
            out[f"net dense {name} {codec}"] = run_async(
                task, topo, b=4, t0=30, ticks=100, attack="random", seed=1, codec=codec,
                scenario=name)
    topo = graph.small_world(512, 6, 1, rewire_prob=0.2, seed=0)
    task = tasks.linear_task(512, 0, partition="iid", num_train=16384, num_test=1000, batch=8)
    out["net sparse lossy"] = run_async(task, topo, b=1, t0=100, ticks=200, attack="alie",
                                        sparse=True, channel=ChannelConfig(drop_prob=0.05),
                                        staleness=2)
    return out


def net_kb():
    out = {}
    topo = graph.erdos_renyi(20, 0.9, 1, seed=0)
    for rule in ("krum", "bulyan"):
        for name in ("ideal", "lossy"):
            task = tasks.linear_task(20, 0, partition="iid", num_train=4000, num_test=800,
                                     batch=32)
            out[f"net {rule} {name}"] = run_async(task, topo, b=1, t0=30, ticks=120,
                                                  attack="alie", scenario=name, rule=rule)
    from repro.net.channel import ChannelConfig

    topo = graph.small_world(512, 6, 1, rewire_prob=0.2, seed=0)
    task = tasks.linear_task(512, 0, partition="iid", num_train=16384, num_test=1000, batch=8)
    out["net sparse krum"] = run_async(task, topo, b=1, t0=100, ticks=20, attack="alie",
                                       sparse=True, channel=ChannelConfig(drop_prob=0.05),
                                       staleness=2, rule="krum")
    return out


ADVERSARY_NAMES = ("random", "alie", "ipm", "alie_online", "dissensus", "inner_max",
                   "equivocate", "slander")


def adversary():
    from repro.sim.grid import default_topology

    out = {}

    def run(task, topo, rule, b, name, ticks=60):
        cfg = bridge.BridgeConfig(topology=topo, rule=rule, num_byzantine=b, attack="none",
                                  adversary=name, lam=1.0, t0=30.0, byzantine_seed=0)
        trainer = bridge.BridgeTrainer(cfg, task.grad_fn)
        state = trainer.init(task.init_fn(0), seed=0)
        for i in range(ticks):
            state, _ = trainer.step(state, jax.tree_util.tree_map(lambda x: x[i], task.batches))
        return task.eval_accuracy(state.params, trainer.honest_mask)

    task = tasks.linear_task(10, 60, partition="extreme", num_train=4000, num_test=800, seed=0)
    topo = default_topology(10, ("trimmed_mean", "median"), (3,), seed=0)
    for rule in ("trimmed_mean", "median"):
        for name in ADVERSARY_NAMES:
            for b in (1, 2, 3):
                out[f"adversary {rule} {name} b{b}"] = run(task, topo, rule, b, name)
    task = tasks.linear_task(20, 60, partition="extreme", num_train=4000, num_test=800, seed=0)
    topo = default_topology(20, ("krum", "bulyan"), (2,), seed=0)
    for rule in ("krum", "bulyan"):
        out[f"adversary {rule} inner_max b2 (M=20)"] = run(task, topo, rule, 2, "inner_max")
    topo = default_topology(20, ("trimmed_mean",), (2,), seed=0)
    for name in ("dissensus", "equivocate"):
        task = tasks.linear_task(20, 0, partition="extreme", num_train=4000, num_test=800)
        out[f"adversary net lossy_laggy {name}"] = run_async(
            task, topo, b=2, t0=30, ticks=60, attack="none", adversary=name,
            scenario="lossy_laggy")
    topo = graph.small_world(512, 6, 1, rewire_prob=0.2, seed=0)
    task = tasks.linear_task(512, 0, partition="iid", num_train=16384, num_test=1000, batch=8)
    out["adversary net sparse lossy inner_max"] = run_async(
        task, topo, b=1, t0=100, ticks=20, attack="none", adversary="inner_max", sparse=True,
        scenario="lossy")
    out.update(adversary_sparse_median())
    return out


def adversary_sparse_median():
    """``adversary``'s sparse `inner_max` run under BRIDGE-M."""
    topo = graph.small_world(512, 6, 1, rewire_prob=0.2, seed=0)
    task = tasks.linear_task(512, 0, partition="iid", num_train=16384, num_test=1000, batch=8)
    return {"adversary net sparse lossy inner_max median": run_async(
        task, topo, b=1, t0=100, ticks=20, attack="none", adversary="inner_max", sparse=True,
        scenario="lossy", rule="median")}


def _certificate(result: dict) -> dict:
    """What `chip_smoke.py` holds the port's certification to."""
    out = {}
    for rule, rrec in result["rules"].items():
        out[rule] = {"feasible_b": rrec["feasible_b"],
                     "ref": {k: rrec["ref"][k] for k in ("final_loss", "score")},
                     "adversaries": {adv: {
                         "bstar": arec["bstar"],
                         "certified_monotone": arec["certified_monotone"],
                         "probes": {b: {k: p[k] for k in ("survived", "final_loss", "score")}
                                    for b, p in arec["probes"].items()}}
                         for adv, arec in rrec["adversaries"].items()}}
    return out


def unstable_quadratic() -> dict:
    """Each probe's first bad tick (the reference probe's, key "0") on the
    unstable quadratic."""
    import jax.numpy as jnp

    from repro.adversary.breakdown import BreakdownConfig, BreakdownEngine
    from repro.sim.engine import stack_batches

    m, d, ticks = 10, 4, 12
    targets = jnp.asarray((3.0 * np.random.default_rng(0).normal(size=(m, d))).astype(np.float32))

    def grad_fn(params, batch):
        w = params["w"]
        return 0.5e4 * jnp.sum((w - batch) ** 2), {"w": 1e4 * (w - batch)}

    def init_fn(seed):
        return bridge.replicate({"w": jnp.zeros(d)}, m, perturb=0.1,
                                key=jax.random.PRNGKey(seed))

    engine = BreakdownEngine(graph.erdos_renyi(m, 0.8, 2, seed=1), ("trimmed_mean",),
                             ("random",), grad_fn, init_fn, stack_batches(lambda i: targets, ticks),
                             lam=1.0, t0=10.0, config=BreakdownConfig(b_max=2))
    engine.run()
    return {str(b): rec["first_bad_tick"] for (_, _, b), rec in engine.probes.items()}


def breakdown():
    from benchmarks.breakdown_bench import run_certification
    from repro.adversary import protocols as adv_lib
    from repro.adversary.breakdown import BreakdownConfig, BreakdownEngine
    from repro.adversary.search import SearchConfig, _sample_theta, red_team_search
    from repro.sim import Cell, ExperimentGrid, GridEngine
    from repro.sim.grid import default_topology

    out = {"breakdown certification": _certificate(run_certification())}
    task = tasks.linear_task(10, 30, num_train=4000, num_test=800, seed=0)
    topo = default_topology(10, ("trimmed_mean",), (2,), seed=0)
    engine = BreakdownEngine(
        topo, ("trimmed_mean",), ("alie_online",), task.grad_fn, task.init_fn, task.batches,
        lam=1.0, t0=30.0, config=BreakdownConfig(b_max=2, score_drop=0.25, loss_ratio=50.0),
        eval_fn=task.eval_accuracy, scenario="lossy")
    out["breakdown scenario lossy"] = _certificate(engine.run())
    out["breakdown unstable quadratic"] = unstable_quadratic()
    # the search CLI's defaults; generation 0 as red_team_search draws it
    topo = default_topology(10, ("trimmed_mean",), (2,), seed=0)
    task = tasks.linear_task(10, 40, seed=0)
    adv = adv_lib.get_adversary("ipm")
    rng = np.random.default_rng(SearchConfig().seed)
    thetas = [tuple(map(float, adv.default_theta))]
    thetas += [_sample_theta(rng, adv.theta_bounds) for _ in range(SearchConfig().population - 1)]
    grid = ExperimentGrid(topo, ("trimmed_mean",), ("none",), byzantine_counts=(2,),
                          seeds=(0,), adversaries=("ipm",), lam=1.0, t0=30.0)
    cells = [Cell("trimmed_mean", "none", 2, 0, adversary="ipm", mask_seed=0, theta=th)
             for th in thetas]
    eng = GridEngine(grid, task.grad_fn, cells=cells)
    _, metrics = eng.run(eng.init(task.init_fn), task.batches)
    loss = np.asarray(metrics["loss"], np.float64)[:, -1]
    ledger = red_team_search(topo, "trimmed_mean", "ipm", 2, task.grad_fn, task.init_fn,
                             task.batches, lam=1.0, t0=30.0)
    out["search trimmed_mean ipm b2"] = {
        "thetas": [list(t) for t in thetas], "generation0_fitness": loss.tolist(),
        "best_fitness": ledger["best_fitness"], "default_fitness": ledger["default_fitness"],
        "best_theta": ledger["best_theta"], "trace_count": ledger["trace_count"]}
    return out


def trust():
    from benchmarks import obs_bench, trust_bench

    from repro.adversary.breakdown import BreakdownConfig, BreakdownEngine
    from repro.core import complete_graph
    from repro.trust import TrustSpec

    # trust_bench.breakdown_study(15, ticks=64, b_max=7), each arm's whole
    # certificate kept (its b = 0 reference probe included)
    task = tasks.linear_task(15, 64, partition="moderate", num_train=2000, num_test=400, seed=0)
    cfg = BreakdownConfig(mode="ladder", seeds=(0,), b_max=7, loss_ratio=50.0, score_drop=0.15)
    out = {"trust breakdown": {}}
    for arm, rule, spec in (("static", "trimmed_mean", None),
                            ("rep_trust", "rep_trimmed_mean", TrustSpec(warmup=4))):
        res = BreakdownEngine(complete_graph(15, 7), (rule,), ("equivocate",), task.grad_fn,
                              task.init_fn, task.batches, lam=1.0, t0=30.0, config=cfg,
                              eval_fn=task.eval_accuracy, scenario="ideal", trust=spec).run()
        out["trust breakdown"][arm] = _certificate(res)[rule]
    det = trust_bench.detection_cells(12, ticks=16, b=2)
    out["trust detection"] = {adv: {k: v for k, v in rec.items() if k != "spec"}
                              for adv, rec in det["cells"].items()}
    out["trust inertness"] = {
        "bit_identical": trust_bench.inertness_overhead(32, ticks=12, reps=1)["bit_identical"]}
    for name, kw in (("stress", dict(ticks=20)),
                     ("paper", dict(ticks=3, paper=True, decide_stride=16))):
        rec = obs_bench.trace_overhead(512, reps=1, budget=1.0, **kw)
        out[f"obs trace {name}"] = {k: rec[k] for k in ("bit_identical", "auc_byzantine_edges",
                                                         "survival", "k", "dim")}
    return out


# `chip_smoke.py` phase 24(b)'s sweep: grid_bench's grid (T / M x random,
# alie, sign_flip x 8 seeds, M = 12, b = 2) through `sweep --mode grid --trace`
SWEEP_OBS_ARGS = ["--mode", "grid", "--rules", "trimmed_mean,median", "--attacks",
                  "random,alie,sign_flip", "--byz", "2", "--seeds", "0,1,2,3,4,5,6,7",
                  "--grid-nodes", "12", "--grid-ticks", "30", "--grid-train", "4000",
                  "--grid-test", "800"]


def sweep_obs():
    """Each cell's AUC of the trim frequencies ranking Byzantine in-edges in
    ``obs_summary.json`` after the reference's ``sweep --mode grid --trace``
    at `SWEEP_OBS_ARGS`."""
    import tempfile

    from repro.launch import sweep as jsweep

    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        jsweep.main(SWEEP_OBS_ARGS + ["--out", os.path.join(tmp, "out"), "--trace", run])
        with open(os.path.join(run, "obs_summary.json")) as f:
            cells = json.load(f)["cells"]
    return {"sweep obs auc": {c["tag"]: c["auc_byzantine_edges"] for c in cells}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="dense,sparse,variants")
    args = ap.parse_args()
    groups = {"dense": dense, "sparse": sparse, "variants": variants, "wire": wire,
              "wire_sparse": wire_sparse, "variants_wire": variants_wire, "net": net,
              "net_kb": net_kb, "adversary": adversary, "breakdown": breakdown,
              "trust": trust, "sweep_obs": sweep_obs}
    results = {}
    for name in args.only.split(","):
        t0 = time.perf_counter()
        res = groups[name]()
        for k, v in res.items():
            if isinstance(v, dict) and "accuracy" not in v:
                print(f"{k}: {json.dumps(v)}")
                continue
            acc = v["accuracy"] if isinstance(v, dict) else v
            print(f"{k}: honest test accuracy {acc:.4f}")
        print(f"({name}: {time.perf_counter() - t0:.0f} s, backend {jax.default_backend()})")
        results.update(res)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
