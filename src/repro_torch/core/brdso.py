"""BRDSO baseline (Peng, Li & Ling [60]) — port of `repro.core.brdso`,
which the paper's Figs. 6-7 compare BRIDGE-T to: decentralized SGD with a
total-variation penalty, whose subgradient step is

    w_j(t+1) = w_j(t) - rho(t) * ( grad f_j(w_j(t))
                + lam0 * sum_{i in N_j} sign(w_j(t) - w_i(t)) ),

``w_i`` being what i broadcast (Byzantine rows substituted).  Plain
PyTorch: the reference has no kernel here.  The sum of signs has integer
summands, so it is exact in any order; it is formed over blocks of nodes
(`TV_BLOCK_ELEMS` elements of ``[nodes, M, d]`` at a time) rather than one
``[M, M, d]`` tensor, which would be 78 MB at M = 50 and 8 GB at M = 512.
XLA fuses the update into two single-rounding multiply-adds,
``w - rho * fma(lam0, tv, g)`` (`ref.fma_f32`).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import byzantine
from repro_torch.core.bridge import Params, cell_step_size, stack_flatten
from repro_torch.core.graph import Topology
from repro_torch.device import resolve_device
from repro_torch.kernels import ref

# elements of one [nodes, M, d] block of signs
TV_BLOCK_ELEMS = 1 << 24


class BrdsoState(NamedTuple):
    params: Params  # leaves with leading node axis [M, ...]
    t: int
    key: np.ndarray  # Threefry key (repro_torch.prng)


@dataclasses.dataclass(frozen=True)
class BrdsoConfig:
    topology: Topology
    num_byzantine: int = 0
    attack: str = "none"
    byzantine_seed: int = 0
    lam: float = 1.0
    t0: float = 50.0
    lam0: float = 0.05  # TV-penalty weight
    lr: float = 0.0

    def step_size(self, t: int) -> float:
        return cell_step_size(self.lam, self.t0, self.lr, t)


def tv_subgradient(w: torch.Tensor, w_bcast: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
    """``[M, d]``: ``sum_{i in N_j} sign(w_j - w_bcast_i)`` for every node j
    under ``adjacency [M, M]`` (bool), a block of nodes at a time."""
    m, d = w.shape
    step = max(1, TV_BLOCK_ELEMS // max(m * d, 1))
    out = []
    for j0 in range(0, m, step):
        signs = torch.sign(w[j0:j0 + step, None, :] - w_bcast[None])
        out.append(torch.sum(torch.where(adjacency[j0:j0 + step, :, None], signs, 0.0), dim=1))
    return torch.cat(out, dim=0)


class BrdsoTrainer:
    """``grad_fn(params, batch) -> (losses [M], grads)`` over the stacked
    ``[M, ...]`` parameters."""

    def __init__(self, config: BrdsoConfig, grad_fn: Callable, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.grad_fn = grad_fn
        self.adjacency = torch.as_tensor(config.topology.adjacency, dtype=torch.bool,
                                         device=self.device)
        self.byz_mask = byzantine.byzantine_nodes(config.topology.num_nodes, config.num_byzantine,
                                                  config.attack, config.byzantine_seed, self.device)
        self.attack = byzantine.get_attack(config.attack)

    def init(self, params: Params, seed: int = 0) -> BrdsoState:
        return BrdsoState({k: v.to(self.device) for k, v in params.items()}, 0, prng.PRNGKey(seed))

    def step(self, state: BrdsoState, batch: Any) -> tuple[BrdsoState, dict]:
        cfg = self.config
        w, unflatten = stack_flatten(state.params)
        keys = prng.split(state.key)
        key, sub = keys[0], keys[1]
        w_bcast = self.attack(w, self.byz_mask, sub, state.t)
        tv = tv_subgradient(w, w_bcast, self.adjacency)
        losses, grads = self.grad_fn(state.params, batch)
        g, _ = stack_flatten(grads)
        rho = cfg.step_size(state.t)
        inner = ref.fma_f32(torch.full_like(tv, cfg.lam0), tv, g)
        w_new = ref.fma_f32(torch.full_like(inner, -rho), inner, w)
        hm = ~self.byz_mask
        cnt = torch.sum(hm).to(torch.float32)
        mu = torch.sum(torch.where(hm[:, None], w_new, 0.0), dim=0) / cnt
        dev = torch.where(hm[:, None], w_new - mu[None, :], 0.0)
        metrics = {
            "loss": torch.sum(torch.where(hm, losses, 0.0)) / cnt,
            "consensus_dist": torch.sqrt(torch.max(torch.sum(dev * dev, dim=1))),
        }
        return BrdsoState(unflatten(w_new), state.t + 1, key), metrics
