"""ByRDiE baseline (Yang & Bajwa, 2019 [58]) — port of `repro.core.byrdie`,
the coordinate-descent predecessor the paper compares against in Fig. 3.

One ByRDiE *sweep* visits every coordinate: the nodes exchange scalar
values, screen them with the scalar trimmed mean and take a coordinate
gradient step.  As in the reference, the coordinates go in ``block``-sized
groups with the gradient recomputed per group (``block=1`` is exact
ByRDiE); the communication count stays exact (``d`` scalars per node per
sweep).  Each block is screened through `screening.screen_all` with
``rule="trimmed_mean"``, so on the card the trimmed-mean kernel runs once
per block, in its reciprocal form: the reference closes over the
adjacency and passes ``b`` static, so XLA multiplies by the float32
reciprocal of ``count - 2 b_eff + 1`` instead of dividing
(``tools/xla_divisor_forms.py``).

The reference's program is kept where it is odd: the padded iterate is
cut into blocks of ``block`` coordinates, but the gradient's window is a
``dynamic_slice`` of the unpadded ``[M, d]`` gradient, which JAX clamps to
fit, so the last block steps its coordinates with the gradient of the last
``block`` coordinates (ROADMAP Queue 3).  Its update ``y - rho g`` has no
fence, and XLA fuses it into one rounding (`ref.fma_f32`).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import byzantine, screening
from repro_torch.core.bridge import Params, cell_step_size, stack_flatten
from repro_torch.core.graph import Topology
from repro_torch.device import resolve_device
from repro_torch.kernels import ref


class ByrdieState(NamedTuple):
    params: Params  # leaves with leading node axis [M, ...]
    t: int  # sweep counter
    key: np.ndarray  # Threefry key (repro_torch.prng)
    scalars_sent: float  # cumulative per-node scalar broadcasts


@dataclasses.dataclass(frozen=True)
class ByrdieConfig:
    topology: Topology
    num_byzantine: int = 0
    attack: str = "none"
    byzantine_seed: int = 0
    lam: float = 1.0
    t0: float = 50.0
    block: int = 256  # coordinates per gradient recomputation

    def step_size(self, t: int) -> float:
        return cell_step_size(self.lam, self.t0, 0.0, t)


class ByrdieTrainer:
    """``grad_fn(params, batch) -> (losses [M], grads)`` over the stacked
    ``[M, ...]`` parameters, as `repro_torch.core.bridge.BridgeTrainer`
    takes it."""

    def __init__(self, config: ByrdieConfig, grad_fn: Callable, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        config.topology.validate_for_rule("trimmed_mean")
        self.config = config
        self.grad_fn = grad_fn
        self.adjacency = torch.as_tensor(config.topology.adjacency, dtype=torch.bool,
                                         device=self.device)
        self.byz_mask = byzantine.byzantine_nodes(config.topology.num_nodes, config.num_byzantine,
                                                  config.attack, config.byzantine_seed, self.device)
        self.attack = byzantine.get_attack(config.attack)

    def init(self, params: Params, seed: int = 0) -> ByrdieState:
        params = {k: v.to(self.device) for k, v in params.items()}
        return ByrdieState(params, 0, prng.PRNGKey(seed), 0.0)

    def sweep(self, state: ByrdieState, batch: Any) -> tuple[ByrdieState, dict]:
        cfg = self.config
        w0, unflatten = stack_flatten(state.params)
        m, d = w0.shape
        nblocks = -(-d // cfg.block)
        rho = cfg.step_size(state.t)
        keys = prng.split(state.key)
        key, sub = keys[0], keys[1]
        w = torch.nn.functional.pad(w0, (0, nblocks * cfg.block - d))
        for i in range(nblocks):
            # full local gradients at the current iterate
            _, grads = self.grad_fn(unflatten(w[:, :d]), batch)
            g, _ = stack_flatten(grads)
            start = i * cfg.block
            gs = min(start, d - cfg.block)  # the reference's clamped dynamic_slice
            wk = w[:, start:start + cfg.block]
            wk_b = self.attack(wk.contiguous(), self.byz_mask, prng.fold_in(sub, i), state.t)
            yk = screening.screen_all(wk_b, self.adjacency, rule="trimmed_mean",
                                      b=cfg.num_byzantine, recip=True)
            gk = g[:, gs:gs + cfg.block]
            w[:, start:start + cfg.block] = ref.fma_f32(torch.full_like(gk, -rho), gk, yk)
        w_new = w[:, :d]
        sent = state.scalars_sent + d
        losses, _ = self.grad_fn(unflatten(w_new), batch)
        hm = ~self.byz_mask
        loss = torch.sum(torch.where(hm, losses, 0.0)) / torch.sum(hm)
        return (ByrdieState(unflatten(w_new), state.t + 1, key, sent),
                {"loss": loss, "scalars_sent": sent})
