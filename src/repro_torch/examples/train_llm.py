"""End-to-end driver: decentralized BRIDGE training of a ~100M-parameter
transformer on the synthetic token pipeline — port of
``examples/train_llm.py``, on the card by default (``--device cpu`` runs
the plain versions).

It exercises the port's whole stack: the model zoo's dense family, the
chunk-streaming trainer (`repro_torch.stream`, the default: screening runs
per coordinate block on the screening kernels, never forming the flat
``[M, d]`` matrix), topology builders, wire codecs, the trace, trust,
Byzantine injection, the token pipeline and checkpoints.

    PYTHONPATH=src python -m repro_torch.examples.train_llm --steps 200 [--small]
    PYTHONPATH=src python -m repro_torch.examples.train_llm --small \\
        --topology small_world:3 --sparse --codec int8 --trust --trace --attack sign_flip

``--flat`` selects the flat-matrix `BridgeTrainer` (small models only);
``--resume`` restores the full state, the codec and trust carries
included, from the newest checkpoint under ``--ckpt`` (default
``bridge_llm_ckpt`` in the temporary directory), bit for bit the state of an
uninterrupted run.  ``--net`` runs the stream's network path (per-edge
drops over a per-block mailbox, `repro_torch.stream.StreamChannelConfig`
with ``--net-drop``; not with ``--flat``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import checkpoint, prng
from repro_torch.configs import get_config
from repro_torch.core import BridgeConfig, BridgeTrainer, replicate
from repro_torch.core.graph import make_topology
from repro_torch.data.tokens import TokenPipeline, device_batch
from repro_torch.device import resolve_device, set_numerics
from repro_torch.models import api as model_api
from repro_torch.stream import StreamBridgeTrainer, StreamChannelConfig


def model_config(small: bool):
    """``--small``: the ~6.6M-parameter qwen3-family config; else the
    ~100M one (12 layers, d = 768), the reference's two configs."""
    base = get_config("qwen3-4b")
    if small:
        return base.reduced(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                            vocab_size=8192, head_dim=64)
    return dataclasses.replace(base, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                               d_ff=2048, vocab_size=32768, head_dim=64, kv_chunk=256,
                               q_chunk=128)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--byzantine", type=int, default=1)
    ap.add_argument("--attack", default="random")
    ap.add_argument("--rule", default="trimmed_mean",
                    help="screening rule (streaming: coordinate-wise rules only)")
    ap.add_argument("--topology", default="erdos_renyi:0.9",
                    help="name[:arg] of repro_torch.core.graph.make_topology")
    ap.add_argument("--sparse", action="store_true", help="neighbor-indexed [M, K] screening")
    ap.add_argument("--codec", default="identity",
                    help="wire codec (identity | int8 | int4 | topk<P> | randk<P>)")
    ap.add_argument("--trace", action="store_true",
                    help="screening forensics in the step (repro_torch.obs)")
    ap.add_argument("--metrics", default=None, metavar="DIR",
                    help="stream per-tick live metrics to DIR/metrics.jsonl via the chunked "
                         "runner; watch with `python -m repro_torch.obs.monitor DIR`")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record the loop under torch.profiler into DIR/profile.trace.json")
    ap.add_argument("--trust", action="store_true",
                    help="reputation-weighted screening + eviction (repro_torch.trust)")
    ap.add_argument("--flat", action="store_true",
                    help="the flat [M, d] BridgeTrainer instead of repro_torch.stream")
    ap.add_argument("--net", action="store_true",
                    help="the stream's network path (per-edge drops, per-block mailboxes)")
    ap.add_argument("--net-drop", type=float, default=0.1, help="per-edge drop probability")
    ap.add_argument("--chunk", type=int, default=1 << 16,
                    help="streaming block width (coordinates per block)")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--small", action="store_true", help="~6.6M params instead of ~100M")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "bridge_llm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint (the full state, carries included)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns the final state and the last tick's loss."""
    args = parse_args(argv)
    if args.net and args.flat:
        raise ValueError("--net runs the stream's network path; drop --flat")
    dev = resolve_device(args.device)
    set_numerics()
    cfg = model_config(args.small)
    api = model_api.build(cfg)
    n = model_api.param_count(cfg)
    print(f"model: {cfg.name}-derived, {n / 1e6:.1f}M params x {args.nodes} nodes on {dev}")

    trace = trust = None
    if args.trace:
        from repro_torch.obs.trace import TraceSpec

        trace = TraceSpec()
    if args.trust:
        from repro_torch.trust.reputation import TrustSpec

        # no echo on the broadcast paths; the streaming network path refuses it
        trust = TrustSpec(echo=False)
    mspec = None
    if args.metrics:
        from repro_torch.obs import MetricSpec

        mspec = MetricSpec()

    topo = make_topology(args.topology, args.nodes, args.byzantine, seed=0)
    bcfg = BridgeConfig(topology=topo, rule=args.rule, num_byzantine=args.byzantine,
                        attack=args.attack, codec=args.codec, lr=0.02, sparse=args.sparse,
                        trace=trace, trust=trust, metrics=mspec,
                        screen_chunk=(1 << 20) if args.flat else args.chunk)
    if args.flat:
        trainer = BridgeTrainer(bcfg, api.grad_fn(), device=dev)
    else:
        channel = StreamChannelConfig(drop_prob=args.net_drop) if args.net else None
        trainer = StreamBridgeTrainer(bcfg, api.grad_fn(), channel=channel, device=dev)
    mode = "flat" if args.flat else f"stream(chunk={args.chunk})"
    print(f"trainer: {mode}  rule={args.rule}  topology={args.topology}  codec={args.codec}  "
          f"sparse={args.sparse}  trace={args.trace}  trust={args.trust}  net={args.net}")

    key = prng.PRNGKey(0)
    params = replicate(api.init_params(key, cfg, device=dev), args.nodes, perturb=0.005, key=key)
    state = trainer.init(params)
    del params
    start = 0
    if args.resume:
        latest = checkpoint.latest_step(args.ckpt)
        if latest is not None:
            # template-based restore: the fresh state gives the structure
            # (parameters, the codec / network / trust carries, the key)
            state, _ = checkpoint.restore(args.ckpt, state, step=latest)
            start = latest
            print(f"resumed from step {latest}")
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, args.nodes, seed=0)

    prof = None
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    t0 = time.time()
    last_loss = float("nan")
    if args.metrics:
        # the chunked loop (both trainers share it): the metric ring streams
        # to DIR/metrics.jsonl through a background writer
        from repro_torch.obs import AlertRules, EventLog, MetricWriter, write_manifest

        os.makedirs(args.metrics, exist_ok=True)
        write_manifest(args.metrics, kind="train-llm", config=vars(args))
        events = EventLog(os.path.join(args.metrics, "events.jsonl"))
        writer = MetricWriter(os.path.join(args.metrics, "metrics.jsonl"), alerts=AlertRules(),
                              events=events)
        done = start
        while done < args.steps:
            k = min(args.ckpt_every, args.steps - done)
            state, ms = trainer.run_chunks(state, lambda i: device_batch(pipe.batch(i), dev), k,
                                           writer=writer, events=events, start=done)
            done += k
            last_loss = float(ms["loss"][-1])
            print(f"step {done:4d}  loss {last_loss:.4f}  "
                  f"consensus {float(ms['consensus_dist'][-1]):.3f}  "
                  f"{(time.time() - t0) / (done - start):.2f}s/step", flush=True)
            path = checkpoint.save(args.ckpt, done, state)
            print(f"checkpoint -> {path}")
        writer.close()
        events.close()
        write_manifest(args.metrics, extra={"ended": True, "wall_s": time.time() - t0})
        print(f"metric stream -> {os.path.join(args.metrics, 'metrics.jsonl')}")
    else:
        for step in range(start, args.steps):
            state, metrics = trainer.step(state, device_batch(pipe.batch(step), dev))
            if (step + 1) % 10 == 0 or step + 1 == args.steps:
                extra = ""
                if args.trust:
                    extra += f"  evicted {float(metrics['trust_evicted_frac']):.2f}"
                last_loss = float(metrics["loss"])
                print(f"step {step + 1:4d}  loss {last_loss:.4f}  "
                      f"consensus {float(metrics['consensus_dist']):.3f}{extra}  "
                      f"{(time.time() - t0) / (step - start + 1):.2f}s/step", flush=True)
            if (step + 1) % args.ckpt_every == 0:
                path = checkpoint.save(args.ckpt, step + 1, state)
                print(f"checkpoint -> {path}")

    if prof is not None:
        prof.stop()
        path = os.path.join(args.profile, "profile.trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace -> {path}")
    print("done.")
    return state, last_loss


if __name__ == "__main__":
    main()
