"""End-to-end decentralized training driver — port of `repro.launch.train`,
on the card by default (``--device cpu`` runs the plain versions):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --reduce \\
        --nodes 6 --byzantine 1 --attack random --rule trimmed_mean \\
        --steps 100 --batch 4 --seq 128

``--reduce`` swaps in the reduced config; without it the full config of
``--arch`` is used (the dense family: `repro_torch.models`; the other
families are ROADMAP Queue 1 item 2).  Every node's loss and gradient come
from `repro_torch.models.api.ModelApi.grad_fn`; the screens run the port's
kernels on the card.  ``--ckpt DIR`` saves the full `BridgeState` every
``--ckpt-every`` steps in the reference's checkpoint layout
(`repro_torch.checkpoint`) and resumes from the newest one, bit for bit the
uninterrupted run.

Network scenarios (`repro_torch.net`): ``--net`` routes training through the
unreliable-network runtime; combine with ``--net-drop 0.2 --net-latency 3
--net-schedule churn`` etc.  Message-granularity attacks (selective_victim)
imply ``--net``.

Observability (`repro_torch.obs`): ``--trace DIR`` runs the screens' decide
form and the trace (bit-inert), streams a JSONL event log to
``DIR/events.jsonl`` and dumps ``DIR/obs_summary.json`` for ``python -m
repro_torch.obs.report DIR``; ``--metrics DIR`` the live metric ring through
`CellTrainer.run_chunks`; ``--profile DIR`` records the training loop under
`torch.profiler` (the ``bridge.*`` and ``kernels.*`` ranges) and writes its
Chrome trace to ``DIR/profile.trace.json``.

The ``run.end`` event keeps the reference's fields.  Its ``compile_s`` is,
on the card, the first step's wall time (the first segment's under
``--metrics``), which holds the kernels' first load (and, in a fresh
checkout, their build) and the caching allocator's warm-up: PyTorch runs
eagerly and compiles no step.  ``steady_state_s`` is the rest of the wall.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import checkpoint, prng
from repro_torch.configs import get_config
from repro_torch.core import BridgeConfig, BridgeTrainer, erdos_renyi, replicate
from repro_torch.core.byzantine import ATTACKS, WIRE_ATTACKS
from repro_torch.data.tokens import TokenPipeline, device_batch
from repro_torch.device import resolve_device, set_numerics, wait
from repro_torch.models import api as model_api


def build_trainer(args, topo, grad_fn, device):
    """`BridgeTrainer` (synchronous) or `AsyncBridgeTrainer` (``--net``
    scenarios) on ``device``."""
    trace = None
    if args.trace is not None:
        from repro_torch.obs import TraceSpec

        trace = TraceSpec(reservoir=args.trace_reservoir)
    trust = None
    if args.trust:
        from repro_torch.trust import TrustSpec

        trust = TrustSpec(evict_threshold=args.trust_evict, warmup=args.trust_warmup,
                          echo=not args.trust_no_echo)
    mspec = None
    if args.metrics is not None:
        from repro_torch.obs import MetricSpec

        mspec = MetricSpec(capacity=args.metrics_capacity)
    use_net = args.net or (args.attack not in ATTACKS and args.attack not in WIRE_ATTACKS)
    common = dict(topology=topo, rule=args.rule, num_byzantine=args.byzantine,
                  attack=args.attack, adversary=args.adversary, codec=args.codec, lam=args.lam,
                  t0=args.t0, lr=args.lr, sparse=args.sparse, trace=trace, trust=trust,
                  metrics=mspec)
    if not use_net:
        return BridgeTrainer(BridgeConfig(**common), grad_fn, device=device)
    from repro_torch.net import AsyncBridgeConfig, AsyncBridgeTrainer, ChannelConfig
    from repro_torch.net.dynamic import scenario_schedule

    channel = ChannelConfig(drop_prob=args.net_drop, latency_min=args.net_latency_min,
                            latency_max=args.net_latency, bandwidth_cap=args.net_cap)
    acfg = AsyncBridgeConfig(
        **common, channel=channel, staleness_bound=args.net_staleness,
        schedule=scenario_schedule(args.net_schedule, topo, args.steps, seed=args.seed,
                                   churn_prob=args.net_churn_prob))
    return AsyncBridgeTrainer(acfg, grad_fn, device=device)


def _senders(args, trainer, topo) -> np.ndarray:
    """The ``[M, W]`` sender grid of the trainer's edge slots."""
    from repro_torch.obs import trace as obs_trace

    nbr = (trainer.neighbors if trainer.runtime is None
           else getattr(trainer.runtime, "neighbors", None))
    if nbr is not None:
        return obs_trace.sender_grid(args.nodes, neighbors=nbr)
    # net schedules vary per tick, so the mailbox width is the full grid
    return obs_trace.sender_grid(
        args.nodes, adjacency=None if trainer.runtime is not None else topo.adjacency)


def dump_obs(args, trainer, state, topo, events_path) -> str:
    """Render the final `TraceState` into ``obs_summary.json`` (the input
    of ``python -m repro_torch.obs.report``)."""
    import json

    from repro_torch.obs import trace as obs_trace

    rec = obs_trace.summarize(trainer.config.trace, state.obs,
                              byz_mask=trainer.byz_mask.cpu().numpy(),
                              senders=_senders(args, trainer, topo))
    tag = f"{args.rule}_{args.attack}_b{args.byzantine}_s{args.seed}"
    summary = {"meta": {"nodes": args.nodes, "steps": args.steps, "rule": args.rule,
                        "attack": args.attack, "adversary": args.adversary,
                        "codec": args.codec, "events": events_path},
               "cells": [{"tag": tag, "rule": args.rule, **rec}]}
    path = os.path.join(args.trace, "obs_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True)
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--byzantine", type=int, default=1)
    ap.add_argument("--attack", default="none")
    ap.add_argument("--adversary", default="none",
                    help="adaptive adversary (repro_torch.adversary): ipm, alie_online, "
                         "dissensus, inner_max, or any static attack name")
    ap.add_argument("--rule", default="trimmed_mean")
    ap.add_argument("--codec", default="identity",
                    help="wire codec (repro_torch.comm): identity, int8, int4, "
                         "topk<P>[_int8|_int4], randk<P>[_int8|_int4]")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4, help="per-node batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--t0", type=float, default=100.0)
    ap.add_argument("--lr", type=float, default=0.0, help="constant lr override")
    ap.add_argument("--graph-p", type=float, default=0.8)
    ap.add_argument("--topology", default=None,
                    help="named topology spec (repro_torch.core.graph.make_topology): "
                         "erdos_renyi[:p], small_world[:nearest], geometric[:radius], "
                         "torus[:rows], complete; default builds ER from --graph-p")
    ap.add_argument("--sparse", action="store_true",
                    help="neighbor-indexed [M, K] state layout (the gather kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # network-scenario flags (repro_torch.net)
    ap.add_argument("--net", action="store_true",
                    help="route training through the unreliable-network runtime")
    ap.add_argument("--net-drop", type=float, default=0.0, help="per-link drop probability")
    ap.add_argument("--net-latency", type=int, default=0, help="max link latency (ticks)")
    ap.add_argument("--net-latency-min", type=int, default=0)
    ap.add_argument("--net-cap", type=int, default=None, help="bandwidth cap (coordinates)")
    ap.add_argument("--net-staleness", type=int, default=5,
                    help="max usable message age (ticks)")
    ap.add_argument("--net-schedule", default="static",
                    choices=["static", "churn", "partition", "join_leave"])
    ap.add_argument("--net-churn-prob", type=float, default=0.2)
    # observability flags (repro_torch.obs)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="screening forensics in the step (bit-inert); writes "
                         "DIR/events.jsonl + DIR/obs_summary.json")
    ap.add_argument("--trace-reservoir", type=int, default=0,
                    help="raw-trace reservoir slots kept on the device")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record the training loop under torch.profiler into "
                         "DIR/profile.trace.json")
    ap.add_argument("--metrics", default=None, metavar="DIR",
                    help="the live metric ring in the step (bit-inert), per-tick rows "
                         "streamed to DIR/metrics.jsonl by the chunked runner")
    ap.add_argument("--metrics-capacity", type=int, default=64,
                    help="metric ring slots (= the chunked runner's chunk length)")
    ap.add_argument("--wire-budget-bytes", type=float, default=None,
                    help="alert (obs.alert event) when cumulative wire bytes cross this budget")
    # trust flags (repro_torch.trust)
    ap.add_argument("--trust", action="store_true",
                    help="reputation-weighted screening + eviction (repro_torch.trust)")
    ap.add_argument("--trust-evict", type=float, default=0.5,
                    help="suspicion threshold that latches an edge out")
    ap.add_argument("--trust-warmup", type=int, default=8,
                    help="ticks before evictions can latch")
    ap.add_argument("--trust-no-echo", action="store_true",
                    help="disable the equivocation echo protocol (net path)")
    return ap.parse_args(argv)


def _restore(args, state):
    """Resume from the newest checkpoint under ``--ckpt``: the full state
    (PRNG key, network and codec carries), or a legacy ``(params, t)``
    pair; returns ``(state, start)``."""
    try:
        return checkpoint.restore(args.ckpt, state)
    except ValueError:
        # legacy (params, t) checkpoints: the PRNG / network state restarts
        (p, t), start = checkpoint.restore(args.ckpt, (state.params, state.t))
        print("legacy checkpoint format: PRNG key / network state reinitialized")
        return state._replace(params=p, t=t), start


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    set_numerics()
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    api = model_api.build(cfg)
    print(f"arch={cfg.name} family={cfg.family} params(single)="
          f"{model_api.param_count(cfg):,} device={dev}")

    if args.topology:
        from repro_torch.core.graph import make_topology

        topo = make_topology(args.topology, args.nodes, args.byzantine, seed=args.seed)
    else:
        topo = erdos_renyi(args.nodes, args.graph_p, args.byzantine, seed=args.seed)
    trainer = build_trainer(args, topo, api.grad_fn(), dev)
    key = prng.PRNGKey(args.seed)
    params = replicate(api.init_params(key, cfg, device=dev), args.nodes, perturb=0.01, key=key)
    state = trainer.init(params, seed=args.seed)
    del params
    start = 0
    if args.ckpt and checkpoint.latest_step(args.ckpt) is not None:
        # the *full* BridgeState, the PRNG key and the network runtime's
        # in-flight mailboxes included, so a resumed lossy run replays the
        # channel / attack trace of an uninterrupted one
        state, start = _restore(args, state)
        print(f"resumed from step {start}")

    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, args.nodes, seed=args.seed)

    def batch_at(i):
        return device_batch(pipe.batch(i), dev)

    # run-bracket artifacts: one directory holds the event log, the live
    # metric stream and the manifest (pass the same DIR to --trace and
    # --metrics to keep them together)
    run_dir = args.trace or args.metrics
    events = None
    if run_dir is not None:
        from repro_torch.obs import EventLog, write_manifest

        os.makedirs(run_dir, exist_ok=True)
        extra = {}
        if trainer.runtime is not None:
            extra["network"] = trainer.runtime.describe()
        write_manifest(run_dir, kind="train", config=vars(args), extra=extra)
        events = EventLog(os.path.join(run_dir, "events.jsonl"))
        events.emit("run.start", kind="train", arch=cfg.name, nodes=args.nodes,
                    steps=args.steps, rule=args.rule, attack=args.attack,
                    net=bool(trainer.runtime is not None), resumed_at=start)
    mwriter = None
    if args.metrics is not None:
        from repro_torch.obs import AlertRules, MetricWriter

        os.makedirs(args.metrics, exist_ok=True)
        mwriter = MetricWriter(os.path.join(args.metrics, "metrics.jsonl"),
                               alerts=AlertRules(wire_budget_bytes=args.wire_budget_bytes),
                               events=events)
    prof = None
    if args.profile is not None:
        os.makedirs(args.profile, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    t_run = time.time()
    compile_s = 0.0
    t_last = time.time()
    last_loss = float("nan")
    if mwriter is not None:
        # chunked tick loop: the metric ring flushed to the writer thread
        # after each chunk, without waiting for the card
        seg = args.ckpt_every if args.ckpt else max(args.steps - start, 1)
        done = start
        while done < args.steps:
            n = min(seg, args.steps - done)
            state, ms = trainer.run_chunks(state, batch_at, n, writer=mwriter, events=events,
                                           start=done)
            if done == start:
                wait(dev)
                compile_s = time.time() - t_run
            done += n
            if args.ckpt:
                checkpoint.save(args.ckpt, done, state)
            dt = time.time() - t_last
            t_last = time.time()
            last_loss = float(ms["loss"][-1])
            print(f"step {done:5d}  loss {last_loss:.4f}  "
                  f"consensus {float(ms['consensus_dist'][-1]):.4f}  "
                  f"rho {float(ms['rho'][-1]):.5f}  {dt / n:.2f}s/step", flush=True)
    else:
        for step in range(start, args.steps):
            state, metrics = trainer.step(state, batch_at(step))
            if step == start:
                # the first step's wall: the kernels' first load and the
                # allocator's warm-up (see the module docstring)
                wait(dev)
                compile_s = time.time() - t_run
            if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                dt = time.time() - t_last
                t_last = time.time()
                net = ""
                if "delivered_frac" in metrics:
                    net = (f"  delivered {float(metrics['delivered_frac']):.2f}"
                           f"  stale {float(metrics['mean_staleness']):.1f}")
                if args.codec != "identity" and "wire_bits_per_edge" in metrics:
                    net += f"  wire {float(metrics['wire_bits_per_edge']) / 8:.0f}B/edge"
                last_loss = float(metrics["loss"])
                print(f"step {step + 1:5d}  loss {last_loss:.4f}  "
                      f"consensus {float(metrics['consensus_dist']):.4f}  "
                      f"rho {float(metrics['rho']):.5f}{net}  "
                      f"{dt / args.log_every:.2f}s/step", flush=True)
            if args.ckpt and (step + 1) % args.ckpt_every == 0:
                checkpoint.save(args.ckpt, step + 1, state)
    wait(dev)
    wall = time.time() - t_run
    if prof is not None:
        prof.stop()
        path = os.path.join(args.profile, "profile.trace.json")
        prof.export_chrome_trace(path)
        if events is not None:
            events.emit("profile.capture", dir=args.profile)
        print(f"profiler trace -> {path}")
    if mwriter is not None:
        mwriter.close()
        print(f"metric stream -> {os.path.join(args.metrics, 'metrics.jsonl')}  "
              f"(watch: python -m repro_torch.obs.monitor {args.metrics})")
    if events is not None:
        events.emit("run.end", steps=args.steps - start, wall_s=wall, compile_s=compile_s,
                    steady_state_s=max(wall - compile_s, 0.0))
        if state.obs is not None:
            first_bad = int(state.obs.first_bad)
            if first_bad >= 0:
                events.emit("obs.divergence", cell="train", first_bad_tick=first_bad)
        events.close()
    if args.trace is not None:
        path = dump_obs(args, trainer, state, topo, os.path.join(run_dir, "events.jsonl"))
        print(f"obs summary -> {path}  (render: python -m repro_torch.obs.report {args.trace})")
    if run_dir is not None:
        from repro_torch.obs import write_manifest

        write_manifest(run_dir, extra={"ended": True, "wall_s": wall, "steps": args.steps})
    if args.trust:
        from repro_torch.trust import summarize as trust_summarize

        rec = trust_summarize(trainer.config.trust, state.trust,
                              byz_mask=trainer.byz_mask.cpu().numpy(),
                              senders=_senders(args, trainer, topo))
        print(f"trust: evicted {rec['edges_evicted']} edges "
              f"(byz {rec.get('byz_evicted', 0)}, honest {rec.get('honest_evicted', 0)}, "
              f"max suspicion {rec['max_suspicion']:.2f})")
    print("done.")
    return state, last_loss


if __name__ == "__main__":
    main()
