"""Red-team hyperparameter search: find the theta that breaks a rule —
port of `repro.adversary.search`.

An adaptive adversary is only as strong as its hyperparameters.  This
searches the registered ``theta_bounds`` box of one adversary against one
(rule, b) defense with a random + evolutionary loop whose whole proposal
population runs as the cells of one grid engine on the card:

* generation 0: the registered default plus uniform draws inside the
  bounds;
* every later generation: the elite (highest honest damage) survive, the
  rest are gaussian mutations of random elites, clipped to the bounds
  (the proposals come from the reference's numpy generator, draw for
  draw);
* fitness is the mean final honest loss over the evaluation seeds
  (maximized), a non-finite trace scoring +inf;
* the population's structure never changes, so `GridEngine.set_cells`
  swaps the thetas in as data: the engine's steps are built once, and the
  ledger's ``trace_count`` (the reference's compilations, here
  `GridEngine.num_steps_built`) stays 1.

    PYTHONPATH=src python -m repro_torch.adversary.search --rule trimmed_mean \\
        --adversary ipm --b 2 [--population 12] [--generations 4] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.adversary import protocols as adv_lib
from repro_torch.sim import Cell, ExperimentGrid, GridEngine


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    population: int = 12
    generations: int = 4
    elite: int = 3
    mutation_scale: float = 0.15  # gaussian sigma as a fraction of each bound's width
    seeds: tuple[int, ...] = (0,)  # evaluation seeds per proposal
    seed: int = 0  # the search's own generator


def _sample_theta(rng: np.random.Generator, bounds) -> tuple[float, ...]:
    return tuple(
        0.0 if hi <= lo else float(rng.uniform(lo, hi)) for lo, hi in bounds
    )


def _mutate_theta(rng: np.random.Generator, theta, bounds, scale: float) -> tuple[float, ...]:
    out = []
    for x, (lo, hi) in zip(theta, bounds, strict=True):
        if hi <= lo:
            out.append(0.0)
            continue
        out.append(float(np.clip(x + rng.normal() * scale * (hi - lo), lo, hi)))
    return tuple(out)


def red_team_search(topology, rule: str, adversary: str, b: int,
                    grad_fn: Callable, init_fn: Callable, batches, *,
                    lam: float = 1.0, t0: float = 30.0,
                    config: SearchConfig = SearchConfig(),
                    engine_chunk: int | None = None,
                    device: str | torch.device = "cuda") -> dict:
    """Search ``adversary``'s theta box against ``(rule, b)`` over
    ``batches`` (stacked ``[T, ...]`` on ``device``).  Returns the
    reference's ledger (best theta and fitness, the default's fitness, the
    per-generation history, ``trace_count``) plus ``step_calls``, the group
    steps the engine ran (one a group and tick)."""
    adv = adv_lib.get_adversary(adversary)
    if all(hi <= lo for lo, hi in adv.theta_bounds):
        raise ValueError(f"adversary {adversary!r} has no searchable theta slots")
    rng = np.random.default_rng(config.seed)
    pop = max(config.population, 2)
    ns = len(config.seeds)

    def cells_for(thetas: Sequence[tuple]) -> list[Cell]:
        return [Cell(rule, "none", b, s, adversary=adversary, mask_seed=s, theta=th)
                for th in thetas for s in config.seeds]

    thetas = [tuple(map(float, adv.default_theta))]
    thetas += [_sample_theta(rng, adv.theta_bounds) for _ in range(pop - 1)]
    grid = ExperimentGrid(topology, (rule,), ("none",), byzantine_counts=(b,),
                          seeds=config.seeds, adversaries=(adversary,),
                          lam=lam, t0=t0)
    engine = GridEngine(grid, grad_fn, cells=cells_for(thetas), device=device)
    state0 = engine.init(init_fn)

    history, best_theta, best_fit = [], None, -np.inf
    default_fit = None
    t_start = time.time()
    for gen in range(config.generations):
        if gen > 0:
            engine.set_cells(cells_for(thetas))
        _, metrics = engine.run(state0, batches, chunk=engine_chunk)
        loss = metrics["loss"].cpu().numpy().astype(np.float64)  # [pop*ns, T]
        fits = []
        for j in range(pop):
            tail = loss[j * ns:(j + 1) * ns, -1]
            # a non-finite honest trace is a total break: top fitness
            fits.append(np.inf if not np.isfinite(tail).all() else float(np.mean(tail)))
        if gen == 0:
            default_fit = fits[0]  # thetas[0] is the registered default
        order = np.argsort(fits)[::-1]
        if fits[order[0]] > best_fit:
            best_fit, best_theta = fits[order[0]], thetas[order[0]]
        history.append({
            "generation": gen,
            "best_fitness": fits[order[0]],
            "best_theta": list(thetas[order[0]]),
            "mean_fitness": float(np.mean([f for f in fits if np.isfinite(f)] or [np.inf])),
        })
        elite = [thetas[i] for i in order[:config.elite]]
        thetas = list(elite)
        while len(thetas) < pop:
            if rng.random() < 0.25:  # fresh random blood
                thetas.append(_sample_theta(rng, adv.theta_bounds))
            else:
                parent = elite[rng.integers(len(elite))]
                thetas.append(_mutate_theta(rng, parent, adv.theta_bounds,
                                            config.mutation_scale))
    return {
        "rule": rule, "adversary": adversary, "b": b,
        "best_theta": list(best_theta),
        "best_fitness": best_fit,
        "default_fitness": default_fit,
        "generations": history,
        "trace_count": engine.num_steps_built,
        "step_calls": engine.step_calls,
        "wall_s": time.time() - t_start,
        "proposals_evaluated": pop * config.generations,
    }


def main(argv=None) -> dict:
    """The reference's CLI (its flags and defaults) plus ``--device``;
    returns the ledger."""
    import argparse
    import json

    from repro_torch.sim import default_topology
    from repro_torch.sim.tasks import linear_task

    ap = argparse.ArgumentParser()
    ap.add_argument("--rule", default="trimmed_mean")
    ap.add_argument("--adversary", default="ipm")
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=10)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--population", type=int, default=12)
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--out", default=None, help="write the ledger JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    topo = default_topology(args.nodes, (args.rule,), (args.b,), seed=0)
    task = linear_task(args.nodes, args.ticks, seed=0, device=args.device)
    ledger = red_team_search(
        topo, args.rule, args.adversary, args.b,
        task.grad_fn, task.init_fn, task.batches, lam=1.0, t0=30.0,
        config=SearchConfig(population=args.population, generations=args.generations),
        device=args.device)
    print(json.dumps({k: v for k, v in ledger.items() if k != "generations"}, indent=2,
                     default=str))
    for g in ledger["generations"]:
        print(f"  gen {g['generation']}: best={g['best_fitness']:.4g} "
              f"theta={[round(t, 3) for t in g['best_theta']]}")
    if ledger["trace_count"] != 1:
        raise SystemExit(f"expected one step built, got {ledger['trace_count']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(ledger, f, indent=2, default=str)
    return ledger


if __name__ == "__main__":
    main()
