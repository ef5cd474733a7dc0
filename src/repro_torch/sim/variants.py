"""The four BRIDGE screening variants (T/M/K/B) against DGD under attack,
plus the ByRDiE and BRDSO baselines — port of `examples/bridge_variants.py`
and of the harness it drives, `benchmarks/common.py` (``run_decentralized``,
``_baseline_setup``, ``run_byrdie``, ``run_brdso``).

    python -m repro_torch.sim.variants [--nodes 20 --byzantine 2 --steps 120 \\
        --attack random --codec int8 --sparse --device cpu]

Prints the reference's table: variant, codec, honest-node test accuracy,
consensus distance, bytes per edge per step and ms per step, for DGD and
BRIDGE-T/M/K/B, then ByRDiE and BRDSO.  The defaults are the reference's:
M = 20, b = 2, 120 steps, batch 32, ``t0 = 30``, the MNIST-like data at
4000 / 800 samples, an ``erdos_renyi`` graph with ``p`` raised from 0.5
until the rule's Table II bound holds; the baselines run on the linear task
at 4000 / 800 samples over ``erdos_renyi(M, 0.5, b)``, ByRDiE with
``block=512`` for 2 sweeps, BRDSO with ``lam0=0.05``.

``--codec`` takes every codec of `repro_torch.comm.codec` and ``--attack``
the wire attacks too (``garbage_codeword``, ``scale_abuse``,
``index_lie``); the baselines take the broadcast attack, ``random`` in
place of a wire attack, as the reference's example does.  ``--adversary``
swaps the attack for a `repro_torch.adversary` entry (``ipm``,
``alie_online``, ``dissensus``, ``inner_max``, ``equivocate``,
``slander`` or a static attack's name); the baselines, which take no
adversary bank, keep ``--attack``.  ``--sparse`` runs the variants on the
neighbor-table layout; ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import time
from collections.abc import Sequence

import torch

from repro_torch import prng
from repro_torch.core.brdso import BrdsoConfig, BrdsoTrainer
from repro_torch.core.bridge import BridgeConfig, BridgeTrainer, replicate
from repro_torch.core import byzantine
from repro_torch.core.byrdie import ByrdieConfig, ByrdieTrainer
from repro_torch.core.graph import erdos_renyi
from repro_torch.data.partition import (
    device_node_batches,
    partition_extreme_noniid,
    partition_iid,
    partition_moderate_noniid,
)
from repro_torch.device import resolve_device
from repro_torch.models import small
from repro_torch.sim.tasks import dataset, honest_accuracy, linear_task

VARIANTS = (("mean", "DGD"), ("trimmed_mean", "BRIDGE-T"), ("median", "BRIDGE-M"),
            ("krum", "BRIDGE-K"), ("bulyan", "BRIDGE-B"))
WIRE_ATTACKS = tuple(name for name in byzantine.WIRE_ATTACKS if name != "none")
ATTACK_CHOICES = ("random", "sign_flip", "same_value", "alie", "shift", *WIRE_ATTACKS)
PARTITIONS = {"iid": partition_iid, "extreme": partition_extreme_noniid,
              "moderate": partition_moderate_noniid}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pick_topology(num_nodes: int, num_byzantine: int, rule: str, seed: int):
    """``erdos_renyi`` with ``p`` raised from 0.5 until ``rule``'s Table II
    bound holds (``p = 1`` is the complete graph)."""
    for p in (0.5, 0.6, 0.7, 0.8, 0.9, 1.0):
        try:
            cand = erdos_renyi(num_nodes, p, num_byzantine, seed=seed)
            cand.validate_for_rule(rule)
            return cand
        except (RuntimeError, ValueError):
            continue
    raise RuntimeError(f"no graph for rule={rule}, b={num_byzantine}, M={num_nodes}")


def run_decentralized(*, rule: str = "trimmed_mean", attack: str = "none",
                      adversary: str = "none", codec: str = "identity", num_nodes: int = 20,
                      num_byzantine: int = 0, partition: str = "iid", steps: int = 120,
                      batch: int = 32, lam: float = 1.0, t0: float = 30.0, seed: int = 0,
                      sparse: bool = False, device: str | torch.device = "cuda") -> dict:
    """One BRIDGE (or DGD) run on the linear task; returns the honest
    accuracy, the last tick's consensus distance and loss, the wire bits per
    edge and the steady time per step (the first step, which builds the
    kernels on a card, excluded)."""
    dev = resolve_device(device)
    x, y, xt, yt = dataset(4000, 800, 0)  # the reference's benchmark data, at seed 0
    shards = PARTITIONS[partition](x, y, num_nodes, seed=seed)
    batch_fn = device_node_batches(shards, batch, seed=seed, device=dev)
    topo = pick_topology(num_nodes, num_byzantine, rule, seed)
    cfg = BridgeConfig(topology=topo, rule=rule, num_byzantine=num_byzantine, attack=attack,
                       adversary=adversary, codec=codec, lam=lam, t0=t0, sparse=sparse)
    trainer = BridgeTrainer(cfg, small.linear_loss_and_grad, device=dev)
    key = prng.PRNGKey(seed)
    state = trainer.init(replicate(small.init_linear(key, device=dev), num_nodes, perturb=0.01,
                                   key=key))
    t_start = time.perf_counter()
    first_s = 0.0
    for i in range(steps):
        state, metrics = trainer.step(state, batch_fn(i))
        if i == 0:
            _sync(dev)
            first_s = time.perf_counter() - t_start
    _sync(dev)
    steady = max(time.perf_counter() - t_start - first_s, 0.0)
    acc = honest_accuracy(state.params, trainer.honest_mask, torch.as_tensor(xt, device=dev),
                          torch.as_tensor(yt, device=dev))
    return {
        "accuracy": acc,
        "consensus": float(metrics["consensus_dist"]),
        "loss": float(metrics["loss"]),
        "us_per_step": steady / max(steps - 1, 1) * 1e6,
        "first_step_s": first_s,
        "wire_bits_per_edge": float(metrics["wire_bits_per_edge"]),
        "trainer": trainer,
        "state": state,
    }


def baseline_attack(attack: str) -> str:
    """The broadcast attack the baselines take: ``attack``, or ``random`` in
    place of a wire attack (neither protocol sends codewords), as in the
    reference's example."""
    return "random" if attack in WIRE_ATTACKS else attack


def baseline_setup(num_nodes: int, num_byzantine: int, partition: str, seed: int,
                   device: str | torch.device):
    """The linear task at the paper benches' data sizes and the baselines'
    graph, ``erdos_renyi(M, 0.5, b)`` (the reference's ``_baseline_setup``)."""
    task = linear_task(num_nodes, partition=partition, num_train=4000, num_test=800, seed=seed,
                       device=device)
    return erdos_renyi(num_nodes, 0.5, num_byzantine, seed=seed), task


def run_byrdie(*, num_nodes: int = 20, num_byzantine: int = 2, attack: str = "random",
               sweeps: int = 2, block: int = 512, partition: str = "iid", t0: float = 30.0,
               seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """ByRDiE (coordinate descent, [58]) on the linear task: each sweep
    screens ``block`` coordinates at a time, ``d`` scalar broadcasts a
    node."""
    topo, task = baseline_setup(num_nodes, num_byzantine, partition, seed, device)
    tr = ByrdieTrainer(ByrdieConfig(topology=topo, num_byzantine=num_byzantine, attack=attack,
                                    block=block, t0=t0), task.grad_fn, device=device)
    st = tr.init(task.init_fn(seed))
    t_start = time.perf_counter()
    for i in range(sweeps):
        st, m = tr.sweep(st, task.batch_fn(i))
    _sync(tr.device)
    wall = time.perf_counter() - t_start
    return {"accuracy": task.eval_accuracy(st.params, ~tr.byz_mask), "loss": float(m["loss"]),
            "scalars_sent": float(m["scalars_sent"]), "us_per_step": wall / sweeps * 1e6,
            "state": st}


def run_brdso(*, num_nodes: int = 20, num_byzantine: int = 2, attack: str = "random",
              steps: int = 120, partition: str = "iid", lam0: float = 0.05, t0: float = 30.0,
              seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """BRDSO (TV-penalty subgradient, [60]) on the linear task."""
    topo, task = baseline_setup(num_nodes, num_byzantine, partition, seed, device)
    tr = BrdsoTrainer(BrdsoConfig(topology=topo, num_byzantine=num_byzantine, attack=attack,
                                  lam0=lam0, t0=t0), task.grad_fn, device=device)
    st = tr.init(task.init_fn(seed))
    t_start = time.perf_counter()
    for i in range(steps):
        st, m = tr.step(st, task.batch_fn(i))
    _sync(tr.device)
    wall = time.perf_counter() - t_start
    return {"accuracy": task.eval_accuracy(st.params, ~tr.byz_mask), "loss": float(m["loss"]),
            "consensus": float(m["consensus_dist"]), "us_per_step": wall / steps * 1e6,
            "state": st}


def main(argv: Sequence[str] | None = None) -> list[dict]:
    """Run the comparison and print its table; returns one dict per row."""
    ap = argparse.ArgumentParser(description="BRIDGE-T/M/K/B against DGD, ByRDiE and BRDSO "
                                             "under attack (the port of examples/bridge_variants.py)")
    ap.add_argument("--byzantine", type=int, default=2)
    ap.add_argument("--attack", default="random", choices=ATTACK_CHOICES)
    ap.add_argument("--adversary", default="none",
                    help="adaptive adversary (repro_torch.adversary): ipm, alie_online, "
                         "dissensus, inner_max, equivocate, slander; overrides --attack")
    ap.add_argument("--codec", default=None,
                    help="wire codec (identity, int8, int4, topk<P>[_int8|_int4], "
                         "randk<P>[_int8|_int4]); when set, each variant runs uncompressed AND "
                         "compressed")
    ap.add_argument("--nodes", type=int, default=20)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--no-baselines", action="store_true",
                    help="skip the ByRDiE / BRDSO comparison rows")
    ap.add_argument("--sparse", action="store_true", help="the neighbor-table [M, K] layout")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    attack = "none" if args.adversary != "none" else args.attack
    codecs = ["identity"] + ([args.codec] if args.codec and args.codec != "identity" else [])
    label_attack = args.adversary if args.adversary != "none" else args.attack
    print(f"{args.nodes} nodes, {args.byzantine} byzantine, attack={label_attack}, "
          f"{'sparse' if args.sparse else 'dense'}, device={args.device}")
    print(f"{'variant':12s} {'codec':12s} {'accuracy':>9s} {'consensus':>10s} "
          f"{'B/edge/step':>12s} {'ms/step':>8s}")
    rows = []
    for rule, label in VARIANTS:
        for codec in codecs:
            r = run_decentralized(rule=rule, attack=attack, adversary=args.adversary, codec=codec,
                                  num_nodes=args.nodes, num_byzantine=args.byzantine,
                                  steps=args.steps, sparse=args.sparse, device=args.device)
            print(f"{label:12s} {codec:12s} {r['accuracy']:9.4f} {r['consensus']:10.4f} "
                  f"{r['wire_bits_per_edge'] / 8:12.0f} {r['us_per_step'] / 1000:8.1f}")
            rows.append({"variant": label, "codec": codec, **r})
    if not args.no_baselines:
        base_attack = baseline_attack(args.attack)
        r = run_byrdie(num_nodes=args.nodes, num_byzantine=args.byzantine, attack=base_attack,
                       sweeps=2, device=args.device)
        print(f"{'ByRDiE':12s} {'scalar':12s} {r['accuracy']:9.4f} {'-':>10s} "
              f"{'-':>12s} {r['us_per_step'] / 1000:8.1f}  "
              f"(2 sweeps = {int(r['scalars_sent'])} scalar broadcasts/node)")
        rows.append({"variant": "ByRDiE", "codec": "scalar", **r})
        r = run_brdso(num_nodes=args.nodes, num_byzantine=args.byzantine, attack=base_attack,
                      steps=args.steps, device=args.device)
        print(f"{'BRDSO':12s} {'identity':12s} {r['accuracy']:9.4f} {r['consensus']:10.4f} "
              f"{'-':>12s} {r['us_per_step'] / 1000:8.1f}")
        rows.append({"variant": "BRDSO", "codec": "identity", **r})
    return rows


if __name__ == "__main__":
    main()
