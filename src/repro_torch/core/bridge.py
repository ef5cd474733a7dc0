"""The BRIDGE trainer — Algorithm 1 of the paper; port of the synchronous
broadcast path of `repro.core.bridge` (``build_cell_step`` with the
identity codec and no adversary, trace, trust or metrics spec, driven by
``BridgeTrainer``).

All M node replicas live on one device as a stacked ``[M, ...]`` parameter
dict.  One tick:

1. **attack** — Byzantine rows of the broadcast ``w [M, d]`` are substituted
   (`repro_torch.core.byzantine`);
2. **screen** — every node screens the broadcast under its in-neighbor row,
   with its own broadcast value as self (`screening.screen_all`; BRIDGE-T and
   BRIDGE-M run the CUDA kernels on the card);
3. **apply** — ``w_j <- y_j - rho(t) * grad f_j(w_j)`` with
   ``rho(t) = 1 / (lam (t0 + t))``, ``rho * g`` rounded to float32 before the
   subtract as in the reference.

PyTorch runs eagerly, so the reference's ``jit``/``scan`` machinery has no
counterpart: `BridgeTrainer.run` is a Python loop over `BridgeTrainer.step`.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import byzantine, screening
from repro_torch.core.graph import Topology
from repro_torch.device import resolve_device

Params = dict[str, torch.Tensor]


class BridgeState(NamedTuple):
    params: Params  # leaves with leading node axis [M, ...]
    t: int  # iteration counter
    generator: torch.Generator  # the attack's random stream, on the trainer's device


def cell_step_size(lam: float, t0: float, lr: float, t: int) -> float:
    """rho(t) = lr if lr > 0 else 1 / (lam * (t0 + t)), in float32 (Sec. IV)."""
    if lr > 0:
        return float(np.float32(lr))
    f32 = np.float32
    return float(f32(1.0) / (f32(lam) * (f32(t0) + f32(t))))


@dataclasses.dataclass(frozen=True)
class BridgeConfig:
    """Graph, screening rule, threat model and step-size schedule of one
    trainer (the reference's fields for the main path)."""

    topology: Topology
    rule: str = "trimmed_mean"  # trimmed_mean | median | mean
    num_byzantine: int = 0  # the bound b given to the screening rule
    attack: str = "none"
    byzantine_seed: int = 0
    lam: float = 1.0
    t0: float = 50.0
    lr: float = 0.0  # if > 0, a constant step size instead

    def step_size(self, t: int) -> float:
        return cell_step_size(self.lam, self.t0, self.lr, t)


def stack_flatten(params: Params) -> tuple[torch.Tensor, Callable[[torch.Tensor], Params]]:
    """``[M, ...]`` parameter dict -> (``[M, D]`` float32 matrix, unflatten).

    Leaves are concatenated in sorted-key order, the reference's pytree leaf
    order (``b`` before ``w``); ``unflatten`` restores shapes and dtypes."""
    keys = sorted(params)
    m = params[keys[0]].shape[0]
    shapes = [params[k].shape[1:] for k in keys]
    dtypes = [params[k].dtype for k in keys]
    sizes = [int(np.prod(s)) if len(s) else 1 for s in shapes]
    flat = torch.cat([params[k].reshape(m, -1).to(torch.float32) for k in keys], dim=1)

    def unflatten(w: torch.Tensor) -> Params:
        out, off = {}, 0
        for k, shape, size, dtype in zip(keys, shapes, sizes, dtypes, strict=True):
            out[k] = w[:, off:off + size].reshape((m, *shape)).to(dtype)
            off += size
        return out

    return flat, unflatten


def replicate(params: Params, num_nodes: int, *, perturb: float = 0.0,
              generator: torch.Generator | None = None) -> Params:
    """Stack one model into ``[M, ...]`` node replicas, optionally perturbed
    by ``perturb * N(0, 1)`` drawn from ``generator`` leaf by leaf in sorted
    key order (the reference's order; its draws come from ``jax.random``)."""
    out = {}
    for k in sorted(params):
        leaf = params[k]
        stacked = leaf[None].expand((num_nodes, *leaf.shape)).clone()
        if perturb > 0.0:
            if generator is None:
                raise ValueError("replicate(perturb > 0) needs a generator")
            noise = torch.randn(stacked.shape, generator=generator, device=stacked.device,
                                dtype=stacked.dtype)
            stacked = stacked + perturb * noise
        out[k] = stacked
    return out


class BridgeTrainer:
    """Drives Algorithm 1.  ``grad_fn(params, batch) -> (losses [M], grads)``
    computes every node's local loss and gradient over the stacked
    ``[M, ...]`` parameters (e.g. `repro_torch.models.small.linear_loss_and_grad`).
    """

    def __init__(self, config: BridgeConfig, grad_fn: Callable, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        config.topology.validate_for_rule(config.rule)
        self.config = config
        self.grad_fn = grad_fn
        self.attack = byzantine.get_attack(config.attack)
        adj = config.topology.adjacency
        self.adjacency = torch.as_tensor(adj, dtype=torch.bool, device=self.device)
        self.n_edges = float(adj.sum())
        m = config.topology.num_nodes
        nbyz = min(config.num_byzantine, m)
        if config.attack == "none" or nbyz == 0:
            mask = np.zeros((m,), dtype=bool)
        else:
            mask = byzantine.pick_byzantine_mask(m, nbyz, config.byzantine_seed)
        self.byz_mask = torch.as_tensor(mask, device=self.device)

    @property
    def honest_mask(self) -> torch.Tensor:
        return ~self.byz_mask

    def init(self, params: Params, seed: int = 0) -> BridgeState:
        """The state at tick 0 from stacked ``params``; the attack's
        generator is seeded with ``seed``."""
        m = self.config.topology.num_nodes
        for k, leaf in params.items():
            if leaf.shape[0] != m:
                raise ValueError(f"params[{k!r}] leading axis {leaf.shape[0]} != num_nodes {m}")
        params = {k: v.to(self.device) for k, v in params.items()}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return BridgeState(params=params, t=0, generator=gen)

    def step(self, state: BridgeState, batch: Any) -> tuple[BridgeState, dict]:
        """One tick.  The metrics are 0-d tensors on the device (reading one
        waits for the tick) and Python floats for the static quantities."""
        cfg = self.config
        w, unflatten = stack_flatten(state.params)
        d = w.shape[1]
        # (Steps 3-4) broadcast with Byzantine substitution
        with torch.profiler.record_function("bridge.attack"):
            w_bcast = self.attack(w, self.byz_mask, state.generator, state.t)
        # (Step 5) screening at every node; self is the node's own broadcast
        with torch.profiler.record_function("bridge.screen"):
            y = screening.screen_all(w_bcast, self.adjacency, rule=cfg.rule,
                                     b=cfg.num_byzantine, self_vals=w_bcast)
        # (Step 6) local gradient step at w_j(t)
        with torch.profiler.record_function("bridge.apply"):
            losses, grads = self.grad_fn(state.params, batch)
            g, _ = stack_flatten(grads)
            rho = cfg.step_size(state.t)
            w_new = y - rho * g
            metrics = self._metrics(w_new, losses, rho, d)
        return BridgeState(unflatten(w_new), state.t + 1, state.generator), metrics

    def _metrics(self, w_new: torch.Tensor, losses: torch.Tensor, rho: float, d: int) -> dict:
        """The reference's diagnostics over honest nodes, plus the identity
        codec's wire accounting (32 bits per coordinate, no residual)."""
        hm = self.honest_mask
        cnt = torch.sum(hm).to(torch.float32)
        mu = torch.sum(torch.where(hm[:, None], w_new, 0.0), dim=0) / cnt
        dev = torch.where(hm[:, None], w_new - mu[None, :], 0.0)
        bits = float(32 * d)
        return {
            "loss": torch.sum(torch.where(hm, losses, 0.0)) / cnt,
            "consensus_dist": torch.sqrt(torch.max(torch.sum(dev * dev, dim=1))),
            "rho": rho,
            "wire_bits_per_edge": bits,
            "wire_bytes_total": bits / 8.0 * self.n_edges,
            "ef_residual_norm": 0.0,
        }

    def run(self, state: BridgeState, batch_fn: Callable[[int], Any], num_steps: int,
            eval_fn: Callable | None = None, eval_every: int = 0) -> tuple[BridgeState, list[dict]]:
        """``num_steps`` ticks; every ``eval_every`` ticks the metrics (as
        Python numbers) and ``eval_fn(state)`` join the returned history."""
        history = []
        for i in range(num_steps):
            state, metrics = self.step(state, batch_fn(i))
            if eval_fn is not None and eval_every and (i + 1) % eval_every == 0:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(eval_fn(state))
                rec["step"] = i + 1
                history.append(rec)
        return state, history
