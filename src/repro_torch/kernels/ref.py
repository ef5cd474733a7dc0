"""Plain PyTorch versions of the screening kernels.

These carry the numerics of the rules the reference trainer runs
(`repro.core.screening.trimmed_mean` / ``coordinate_median`` reached through
``screen_all_banked``), operation for operation:

* NaN payloads become ``+inf`` (``_sanitize``); masked rows are ``+inf``
  sentinels, so they sort past every finite value;
* the trim width is clamped, ``b_eff = min(b, (count - 1) // 2)``
  (``effective_trim``);
* each column is sorted ascending over the neighbor axis (``torch.sort``
  gives the same values as the reference's Batcher network);
* kept ranks ``[b_eff, count - b_eff)`` are summed left to right
  (``sum_rows``; above `MAX_EXACT_ROWS` rows the reference falls back to
  ``jnp.sum``, and so does this file, with ``torch.sum``);
* the node's own value is added and the total divided by
  ``count - 2 b_eff + 1`` — a true division: the reference's program divides
  whenever the divisor is a run-time value, as it is in its trainer.

Unlike the reference, which screens one node's ``[n, d]`` rows at a time,
every function here takes the shared broadcast ``w [M, d]``, the ``[M, M]``
in-neighbor mask (``adj[j, i]``: i sends to j) and ``self_vals [M, d]``, and
returns ``[M, d]``.  They build the ``[M, M, d]`` masked tensor the kernels
never form; they are the CPU path and the kernels' yardstick for equality,
not a fast path.
"""
from __future__ import annotations

import torch

# The reference's bound for the sequential sum / sorting network
# (`repro.core.screening.sum_rows`, ``sort_rows``): above it, sums go through
# a reduction tree whose order nothing else reproduces.
MAX_EXACT_ROWS = 64


def sanitize(x: torch.Tensor) -> torch.Tensor:
    """NaN -> +inf, so NaN payloads rank as maximal outliers."""
    return torch.where(torch.isnan(x), torch.inf, x)


def effective_trim(b: int, count: torch.Tensor) -> torch.Tensor:
    """``min(b, max((count - 1) // 2, 0))`` per node (floor division)."""
    widest = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0)
    return torch.clamp(torch.full_like(count, max(int(b), 0)), max=widest)


def sum_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Left-to-right sum over ``dim`` for up to `MAX_EXACT_ROWS` rows, the
    reference's ``sum_rows`` order; a library sum above it, as there."""
    n = x.shape[dim]
    if n > MAX_EXACT_ROWS:
        return torch.sum(x, dim=dim)
    total = x.select(dim, 0)
    for i in range(1, n):
        total = total + x.select(dim, i)
    return total


def _masked_rows(w: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """``[M(receiver), M(sender), d]``: sanitized rows, +inf where masked."""
    return torch.where(adj.bool()[:, :, None], sanitize(w)[None], torch.inf)


def trimmed_mean_dense(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor,
                       b: int) -> torch.Tensor:
    """BRIDGE-T (Eqs. 7-10) at every node: drop the ``b_eff`` smallest and
    largest neighbor values per coordinate, add the node's own (unsanitized)
    value, divide by ``count - 2 b_eff + 1``."""
    m = w.shape[0]
    count = adj.bool().sum(dim=1)
    b_eff = effective_trim(b, count)
    order = torch.sort(_masked_rows(w, adj), dim=1).values
    idx = torch.arange(m, device=w.device)[None, :, None]
    keep = (idx >= b_eff[:, None, None]) & (idx < (count - b_eff)[:, None, None])
    total = sum_rows(torch.where(keep, order, 0.0), dim=1) + self_vals
    den = (count - 2 * b_eff + 1).to(w.dtype)
    return total / den[:, None]


def median_dense(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """BRIDGE-M (Eq. 11) at every node: the coordinate-wise median over the
    in-neighbors and the node itself (self joins sanitized); an even count
    averages the two middle order statistics."""
    rows = torch.cat([_masked_rows(w, adj), sanitize(self_vals)[:, None, :]], dim=1)
    order = torch.sort(rows, dim=1).values
    count = adj.bool().sum(dim=1) + 1
    d = w.shape[1]
    lo = torch.div(count - 1, 2, rounding_mode="floor")[:, None, None].expand(-1, 1, d)
    hi = torch.div(count, 2, rounding_mode="floor")[:, None, None].expand(-1, 1, d)
    return 0.5 * (order.gather(1, lo)[:, 0] + order.gather(1, hi)[:, 0])
