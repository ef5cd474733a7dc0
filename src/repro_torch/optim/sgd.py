"""Optimizers and step-size schedules — port of `repro.optim.sgd`, on the
port's flat tensor dicts.

The paper's analysed setting is plain (sub)gradient descent with the
decreasing schedule rho(t) = 1/(lam (t0 + t)) — `bridge_schedule`.  The
BRIDGE update itself is y - rho*g (no optimizer state); momentum and AdamW
are beyond-paper options for the LLM examples (applied to the
post-screening iterate, keeping the screen-then-step structure).

The schedules return Python floats (a tick's step size stays on the host,
as the trainers' ``cell_step_size`` does), computed in float32 as the
reference's ``jnp`` forms are.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Params = dict[str, torch.Tensor]


def bridge_schedule(lam: float = 1.0, t0: float = 50.0):
    def rho(t):
        return 1.0 / (lam * (t0 + t))

    return rho


def constant_schedule(lr: float):
    def rho(t):
        return float(np.float32(lr))

    return rho


def cosine_schedule(peak: float, total_steps: int, warmup: int = 0):
    f32 = np.float32

    def rho(t):
        t = f32(t)
        warm = f32(peak) * t / f32(max(warmup, 1))
        frac = np.clip((t - f32(warmup)) / f32(max(total_steps - warmup, 1)), f32(0.0), f32(1.0))
        cos = f32(0.5) * f32(peak) * (f32(1.0) + np.cos(f32(np.pi) * frac))
        return float(warm if t < warmup else cos)

    return rho


# ---------------------------------------------------------------------------
# momentum
# ---------------------------------------------------------------------------


def momentum_init(params: Params) -> Params:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def momentum_update(grads: Params, state: Params, *, beta: float = 0.9) -> tuple[Params, Params]:
    new_state = {k: beta * state[k] + g.to(torch.float32) for k, g in grads.items()}
    return new_state, new_state


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class AdamWState(NamedTuple):
    mu: Params
    nu: Params
    count: torch.Tensor  # int32, 0-d


def adamw_init(params: Params) -> AdamWState:
    z = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamWState(mu=z, nu={k: v.clone() for k, v in z.items()},
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def adamw_update(params: Params, grads: Params, state: AdamWState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> tuple[Params, AdamWState]:
    count = state.count + 1
    mu = {k: b1 * state.mu[k] + (1 - b1) * g.to(torch.float32) for k, g in grads.items()}
    nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.to(torch.float32))
          for k, g in grads.items()}
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), count.to(torch.float32))
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), count.to(torch.float32))
    c1, c2 = c1.to(count.device), c2.to(count.device)

    def upd(p, m, v):
        step = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - step).to(p.dtype)

    new_params = {k: upd(p, mu[k], nu[k]) for k, p in params.items()}
    return new_params, AdamWState(mu, nu, count)
