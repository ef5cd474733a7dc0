"""Screening rules of the BRIDGE framework (Sec. III, Table II) — port of the
dense broadcast path of `repro.core.screening` for the rules the main path
runs: ``trimmed_mean`` (BRIDGE-T), ``median`` (BRIDGE-M) and ``mean`` (DGD,
no screening).

`screen_all` applies a rule at every node: node j screens the rows of the
shared broadcast ``w [M, d]`` marked in ``adjacency[j]`` and combines them
with its own value ``self_vals[j]``, as the reference's
``screen_all_banked(..., self_vals=...)`` does.  BRIDGE-T and BRIDGE-M go
through `repro_torch.kernels.ops` (a CUDA kernel on the card, its plain
version on the CPU); ``mean`` has no TPU kernel in the reference and stays
plain PyTorch here.

See `repro_torch.kernels.ref` for the numerics each rule reproduces.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.kernels import ops, ref

RULES: tuple[str, ...] = ("trimmed_mean", "median", "mean")

# Minimum in-neighborhood size each rule needs to tolerate b Byzantine nodes
# (Table II), as in the reference.
MIN_NEIGHBORS: dict[str, Callable[[int], int]] = {
    "trimmed_mean": lambda b: 2 * b + 1,
    "median": lambda b: 1,
    "mean": lambda b: 0,
}


def min_neighbors(rule: str, b: int) -> int:
    try:
        return MIN_NEIGHBORS[rule](b)
    except KeyError:
        raise ValueError(
            f"unknown screening rule {rule!r}; options: {sorted(MIN_NEIGHBORS)}") from None


def mean(w: torch.Tensor, adjacency: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """DGD neighbor averaging over N_j and j: the masked rows summed in row
    order, plus self, divided by ``count + 1`` (no NaN guard, as in the
    reference)."""
    adj = adjacency.bool()
    total = ref.sum_rows(torch.where(adj[:, :, None], w[None], 0.0), dim=1) + self_vals
    return total / (adj.sum(dim=1) + 1).to(w.dtype)[:, None]


def screen_all(w: torch.Tensor, adjacency: torch.Tensor, *, rule: str, b: int,
               self_vals: torch.Tensor | None = None) -> torch.Tensor:
    """Apply ``rule`` at every node; returns the ``[M, d]`` screened y_j.
    ``self_vals`` defaults to ``w`` (each node's own broadcast)."""
    if self_vals is None:
        self_vals = w
    if rule == "trimmed_mean":
        return ops.trimmed_mean(w, adjacency, self_vals, b)
    if rule == "median":
        return ops.median(w, adjacency, self_vals)
    if rule == "mean":
        return mean(w, adjacency, self_vals)
    raise ValueError(f"unknown screening rule {rule!r}; options: {list(RULES)}")
