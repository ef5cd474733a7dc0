"""Screening rules of the BRIDGE framework (Sec. III, Table II) — port of
`repro.core.screening` for the rules the main path runs: ``trimmed_mean``
(BRIDGE-T), ``median`` (BRIDGE-M) and ``mean`` (DGD, no screening), on the
dense and on the sparse ``[M, K]`` layout.

* `screen_all` (dense): node j screens the rows of the shared broadcast
  ``w [M, d]`` marked in ``adjacency[j]`` and combines them with its own
  value ``self_vals[j]``, as the reference's
  ``screen_all_banked(..., self_vals=...)`` does.
* `screen_gathered` (sparse, the trainer's entry): node j screens the rows
  its `NeighborTable` slots name, as the reference's trainer does with
  ``screen_views_banked(neighbors.gather_rows(w), neighbors.valid_dev, ...)``.
* `screen_views`: the plain rules over pre-gathered ``[M, K, d]`` views.

BRIDGE-T and BRIDGE-M go through `repro_torch.kernels.ops` (a CUDA kernel
on the card, its plain version on the CPU) and never form ``[M, M, d]`` or
``[M, K, d]`` on the card; ``mean`` has no TPU kernel in the reference and
stays plain PyTorch here.

See `repro_torch.kernels.ref` for the numerics each rule reproduces.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.core.neighbors import NeighborTable
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


def _mean_total(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """The masked views summed in slot order, plus self."""
    return ref.sum_rows(torch.where(mask.bool()[:, :, None], views, 0.0), dim=1) + self_vals


def screen_views(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, *,
                 rule: str, b: int) -> torch.Tensor:
    """Apply ``rule`` at every node over its own views ``[M, K, d]`` under
    ``mask [M, K]`` — the plain rules, the reference's
    ``screen_views_banked`` with the mask as an operand (``mean`` divides
    by ``count + 1``)."""
    if rule == "trimmed_mean":
        return ref.trimmed_mean_views(views, mask, self_vals, b)
    if rule == "median":
        return ref.median_views(views, mask, self_vals)
    if rule == "mean":
        count = mask.bool().sum(dim=1)
        return _mean_total(views, mask, self_vals) / (count + 1).to(views.dtype)[:, None]
    raise ValueError(f"unknown screening rule {rule!r}; options: {list(RULES)}")


def screen_gathered(w: torch.Tensor, table: NeighborTable, *, rule: str, b: int,
                    self_vals: torch.Tensor | None = None) -> torch.Tensor:
    """Apply ``rule`` at every node over the broadcast rows its table slots
    name; returns the ``[M, d]`` screened y_j.  ``self_vals`` defaults to
    ``w``.

    ``mean`` gathers, sums in slot order and multiplies by the reciprocal of
    ``count + 1``: the reference's trainer closes over the table's mask, so
    XLA folds the divisor to a constant and rewrites the division as that
    multiply (ROADMAP Queue 3)."""
    if self_vals is None:
        self_vals = w
    if rule == "trimmed_mean":
        return ops.gather_trimmed_mean(w, table.safe_idx, table.valid_dev, self_vals, b)
    if rule == "median":
        return ops.gather_median(w, table.safe_idx, table.valid_dev, self_vals)
    if rule == "mean":
        count = table.valid_dev.sum(dim=1)
        inv = 1.0 / (count + 1).to(w.dtype)
        return _mean_total(table.gather_rows(w), table.valid_dev, self_vals) * inv[:, None]
    raise ValueError(f"unknown screening rule {rule!r}; options: {list(RULES)}")
