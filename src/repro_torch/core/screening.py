"""Screening rules of the BRIDGE framework (Sec. III, Table II) — port of
`repro.core.screening`: every rule of its ``RULES`` on the dense and on
the sparse ``[M, K]`` layout.

* `screen_all` (dense): node j screens the rows of the shared broadcast
  ``w [M, d]`` marked in ``adjacency[j]`` and combines them with its own
  value ``self_vals[j]``, as the reference's
  ``screen_all_banked(..., self_vals=...)`` does.
* `screen_gathered` (sparse, the trainer's entry): node j screens the rows
  its `NeighborTable` slots name, as the reference's trainer does with
  ``screen_views_banked(neighbors.gather_rows(w), neighbors.valid_dev, ...)``.
* `screen_views` (the network runtime's entry): node j screens its own
  views ``[M, W, d]`` under the usable mask ``[M, W]``, the reference's
  ``screen_views_banked`` with the mask as an operand.

The rules, by what runs them on the card:

* ``trimmed_mean`` (BRIDGE-T) and ``median`` (BRIDGE-M) go through the
  screening kernels of `repro_torch.kernels.ops` and never form
  ``[M, M, d]`` or ``[M, K, d]`` on the card;
  On the views, BRIDGE-T and BRIDGE-M run the views kernels
  (``ops.views_trimmed_mean``, ``ops.views_median``);
* ``krum`` (BRIDGE-K, Eq. 12) and ``bulyan`` (BRIDGE-B) take their
  distances from the pairwise-distance kernel, computed once per tick
  over the broadcast (and the nodes' own values where a lossy codec makes
  them differ) and gathered per node; Krum's scores and Bulyan's
  recursive selection are plain PyTorch batched over the nodes, and
  Bulyan's last stage is the trimmed-mean kernel over the selected set.
  On the views each node needs distances among its own ``W + 1`` views, a
  distance kernel with a node axis, which the port does not have yet: on
  the card `screen_views` refuses them (`VIEWS_DISTANCE_RULES`), on the CPU
  they run the plain version;
* ``mean`` (DGD), ``geomedian``, ``clipped_mean``, ``rep_trimmed_mean`` and
  ``rep_median`` have no TPU kernel in the reference and are plain
  PyTorch here.

Divisors.  In the reference trainer the adjacency (dense) or the table's
mask (sparse) is a closed-over constant, so XLA rewrites a division whose
divisor depends on it alone into a multiply by the reciprocal: ``mean``'s
``count + 1``, ``geomedian``'s first ``sum(fm)`` and ``clipped_mean``'s
``max(count, 1)`` (whose multiply XLA also fuses with the add of self into
one rounding).  `screen_all` and `screen_gathered`, the trainer's entries,
write those forms (``folded=True``); `screen_views`, the reference's
operand form, divides.  A divisor that depends on the data (the trimmed
mean's, Bulyan's, geomedian's Weiszfeld weights, the rep rules') is a true
division everywhere, as there (ROADMAP Queue 3) — except where the
reference also makes ``b`` static: ByRDiE's block screen, which asks
`screen_all` for the trimmed mean's reciprocal form (``recip=True``).

See `repro_torch.kernels.ref` for the numerics each kernel reproduces.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.core.neighbors import NeighborTable
from repro_torch.kernels import ops, ref

RULES: tuple[str, ...] = ("trimmed_mean", "median", "krum", "bulyan", "geomedian",
                          "clipped_mean", "mean", "rep_trimmed_mean", "rep_median")

# Minimum in-neighborhood size each rule needs to tolerate b Byzantine nodes
# (Table II), as in the reference; the rep rules advertise b + 1 (eviction
# by the trust layer instead of out-voting).
MIN_NEIGHBORS: dict[str, Callable[[int], int]] = {
    "trimmed_mean": lambda b: 2 * b + 1,
    "median": lambda b: 1,
    "krum": lambda b: b + 3,
    "bulyan": lambda b: max(4 * b, 3 * b + 2) + 1,
    "geomedian": lambda b: 2 * b + 1,
    "clipped_mean": lambda b: 1,
    "mean": lambda b: 0,
    "rep_trimmed_mean": lambda b: b + 1,
    "rep_median": lambda b: 1,
}


# Rules whose screen over mailbox views needs per-node distances among
# W + 1 views: the card has no kernel for them yet.
VIEWS_DISTANCE_RULES = ("krum", "bulyan")


def views_distance_refusal(rule: str) -> str:
    return (f"{rule} over mailbox views needs per-node distances among W + 1 views (the "
            f"distance kernel with a node axis, ROADMAP Queue 2 E), which the card has no "
            f"kernel for yet; run it with device='cpu' (the plain version), or use the "
            f"synchronous trainer (runtime=None), whose {rule} runs on the distance kernel")


def min_neighbors(rule: str, b: int) -> int:
    try:
        return MIN_NEIGHBORS[rule](b)
    except KeyError:
        raise ValueError(
            f"unknown screening rule {rule!r}; options: {sorted(MIN_NEIGHBORS)}") from None


def _unknown(rule: str) -> ValueError:
    return ValueError(f"unknown screening rule {rule!r}; options: {list(RULES)}")


def _divide(total: torch.Tensor, count: torch.Tensor, folded: bool) -> torch.Tensor:
    """``total [M, d] / count [M]``: a true division, or (``folded``) a
    multiply by the float32 reciprocal, which XLA writes when the divisor
    folds to a constant."""
    den = count.to(total.dtype)[:, None]
    return total * (1.0 / den) if folded else total / den


# ---------------------------------------------------------------------------
# Coordinate-wise and averaging rules over views [M or 1, n, d]
# ---------------------------------------------------------------------------


def _stack_self(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor):
    """The reference's ``stacked = [values; self]`` per node
    (``[M, n + 1, d]``) and ``full_mask = [mask; True]`` (``[M, n + 1]``)."""
    m, n = mask.shape
    stacked = torch.cat([views.expand(m, n, views.shape[-1]), self_vals[:, None]], dim=1)
    full = torch.cat([mask.bool(), torch.ones((m, 1), dtype=torch.bool, device=mask.device)], dim=1)
    return stacked, full


def mean_views(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, *,
               folded: bool = True) -> torch.Tensor:
    """DGD neighbor averaging over N_j and j: the masked rows summed in row
    order, plus self, over ``count + 1`` (no NaN guard, as in the
    reference)."""
    mask = mask.bool()
    total = ref.sum_rows(torch.where(mask[:, :, None], views, 0.0), dim=1) + self_vals
    return _divide(total, mask.sum(dim=1) + 1, folded)


def geometric_median(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, *,
                     iters: int = 8, eps: float = 1e-6, folded: bool = True) -> torch.Tensor:
    """Geometric median over N_j and j by Weiszfeld iterations (the
    reference's ``geometric_median``): start from the masked mean, then
    ``iters`` reweightings by ``fm / sqrt(|x_i - y|^2 + eps)``.  The
    squared norms are ``torch.sum`` over d (XLA sums them in its own
    order) and XLA computes ``fm / sqrt`` as ``fm * rsqrt``, an
    approximation of its own: the port keeps the IEEE ``sqrt`` and
    division, within a few ulps of the reference."""
    stacked, full = _stack_self(views, mask, self_vals)
    fm = full.to(views.dtype)
    y = _divide(ref.sum_rows_mat(stacked * fm[:, :, None], dim=1), full.sum(dim=1), folded)
    for _ in range(iters):
        diff = stacked - y[:, None, :]
        dist = torch.sqrt(torch.sum(diff * diff, dim=2) + eps)
        wts = fm / dist
        y = ref.sum_rows_mat(stacked * wts[:, :, None], dim=1) / ref.sum_rows(wts, dim=1)[:, None]
    return y


def clipped_mean(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, *,
                 tau: float = 1.0, folded: bool = True) -> torch.Tensor:
    """Centered clipping (the reference's ``clipped_mean``): neighbor deltas
    from self clipped to an l2 ball of radius ``tau``, summed in row order,
    divided by ``max(count, 1)`` and added to self.  With ``folded``, XLA's
    form: the reciprocal's multiply fused with the add (one rounding,
    `ref.fma_f32`).  XLA computes ``tau / sqrt`` as ``tau * rsqrt``, an
    approximation the port replaces with the IEEE division."""
    mask = mask.bool()
    delta = views - self_vals[:, None, :]
    nrm = torch.sqrt(torch.sum(delta * delta, dim=2, keepdim=True) + 1e-12)
    clipped = delta * torch.clamp(tau / nrm, max=1.0)
    total = ref.sum_rows_mat(torch.where(mask[:, :, None], clipped, 0.0), dim=1)
    count = torch.clamp(mask.sum(dim=1), min=1).to(views.dtype)[:, None]
    if not folded:
        return self_vals + total / count
    return ref.fma_f32(total, (1.0 / count).expand_as(total).contiguous(), self_vals)


def _weights(mask: torch.Tensor, weights: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    return torch.ones(mask.shape, dtype=dtype, device=mask.device) if weights is None \
        else weights.to(dtype)


def rep_trimmed_mean(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, b: int, *,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """Reputation-weighted BRIDGE-T (the reference's ``rep_trimmed_mean``):
    per coordinate, keep the values between the ``b_eff``-th smallest and
    largest (ties included), then ``(sum w_i v_i + self) / (sum w_i + 1)``
    over the kept ones, ``weights [M, n]`` defaulting to 1.  The
    reference's NaN anchor (``where(min(order) == min(order), y, 0)``) is
    an XLA scheduling device that never fires, since the sorted values are
    NaN-free; it is left out."""
    mask = mask.bool()
    count = mask.sum(dim=1)
    b_eff = ref.effective_trim(b, count)
    masked = torch.where(mask[:, :, None], ref.sanitize(views), torch.inf)
    order = torch.sort(masked, dim=1).values
    d = self_vals.shape[1]
    lo = order.gather(1, b_eff[:, None, None].expand(-1, 1, d))
    hi = order.gather(1, torch.maximum(count - b_eff - 1, b_eff)[:, None, None].expand(-1, 1, d))
    kept = mask[:, :, None] & (masked >= lo) & (masked <= hi)
    wk = torch.where(kept, _weights(mask, weights, views.dtype)[:, :, None], 0.0)
    total = ref.sum_rows_mat(wk * torch.where(kept, masked, 0.0), dim=1) + self_vals
    return total / (ref.sum_rows_mat(wk, dim=1) + 1.0)


def rep_median(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, *,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Reputation-weighted coordinate median (the reference's
    ``rep_median``): per coordinate, the smallest value whose cumulative
    weight reaches half the total (self weighs 1, masked rows 0).  Ties
    keep row order (``argsort(stable=True)``, as ``jnp.argsort``)."""
    stacked, full = _stack_self(views, mask, self_vals)
    w = torch.where(mask.bool(), _weights(mask, weights, views.dtype), 0.0)
    wfull = torch.cat([w, torch.ones_like(w[:, :1])], dim=1)
    sv = torch.where(full[:, :, None], ref.sanitize(stacked), torch.inf)
    order_idx = torch.argsort(sv, dim=1, stable=True)
    sorted_vals = sv.gather(1, order_idx)
    cum = torch.cumsum(wfull[:, :, None].expand_as(sv).gather(1, order_idx), dim=1)
    first = torch.argmax((cum >= 0.5 * cum[:, -1:]).to(torch.uint8), dim=1)
    return sorted_vals.gather(1, first[:, None, :])[:, 0]


def _plain_rule(rule: str, views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                b: int, *, folded: bool = True) -> torch.Tensor | None:
    """The rules that are plain PyTorch on every layout, over views; None
    for the others."""
    if rule == "mean":
        return mean_views(views, mask, self_vals, folded=folded)
    if rule == "geomedian":
        return geometric_median(views, mask, self_vals, folded=folded)
    if rule == "clipped_mean":
        return clipped_mean(views, mask, self_vals, folded=folded)
    if rule == "rep_trimmed_mean":
        return rep_trimmed_mean(views, mask, self_vals, b)
    if rule == "rep_median":
        return rep_median(views, mask, self_vals)
    return None


# ---------------------------------------------------------------------------
# Vector rules (BRIDGE-K, BRIDGE-B) over per-node distance matrices
# ---------------------------------------------------------------------------


def masked_dists(d2: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``+inf`` off the valid pairs of each node's ``[n+1, n+1]`` matrix
    (the reference's ``pairwise_sq_dists`` masking)."""
    return torch.where(full[:, :, None] & full[:, None, :], d2, torch.inf)


def node_dists(d2_global: torch.Tensor, rows: torch.Tensor, self_rows: torch.Tensor,
               mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Node j's ``[n+1, n+1]`` distance matrix among its candidate rows
    ``rows[j]`` (``[M, n]`` indices into the global matrix) and itself
    (``self_rows[j]``, last), gathered from the one ``d2_global`` of the
    tick and masked; returns it with the full mask ``[mask; True]``."""
    idx = torch.cat([rows, self_rows[:, None]], dim=1).long()
    d2 = d2_global[idx[:, :, None], idx[:, None, :]]
    full = torch.cat([mask.bool(), torch.ones_like(mask[:, :1], dtype=torch.bool)], dim=1)
    return masked_dists(d2, full), full


def krum_scores(d2: torch.Tensor, full: torch.Tensor, count: torch.Tensor, b: int,
                ranks: int) -> torch.Tensor:
    """Krum score of every candidate row of every node's masked ``d2``
    (``[M, n1, n1]``): the sum of its ``max(count - b - 2, 1)`` smallest
    distances to the others, in rank order (`ref.sum_rows`); ``+inf`` for
    invalid rows (the reference's ``_krum_scores``).  The chain stops after
    ``ranks`` ranks, a bound on every node's taken count known to the
    caller without reading the card: the ranks past it add ``+0.0``, which
    leaves a sum of distances (never ``-0``) unchanged."""
    n1 = d2.shape[-1]
    eye = torch.eye(n1, dtype=torch.bool, device=d2.device)
    order = torch.sort(torch.where(eye, torch.inf, d2), dim=2).values
    take = torch.clamp(count - b - 2, min=1)
    kept = torch.where(torch.arange(n1, device=d2.device) < take[:, None, None], order, 0.0)
    if n1 <= ref.MAX_EXACT_ROWS:
        kept = kept[:, :, :ranks]
    return torch.where(full, ref.sum_rows(kept, dim=2), torch.inf)


def _widest(mask: torch.Tensor) -> int:
    """The largest in-degree of ``mask [M, n]`` (one read from the card)."""
    return int(mask.sum(dim=1).max()) if mask.numel() else 0


def krum_pick(d2: torch.Tensor, full: torch.Tensor, mask: torch.Tensor, b: int) -> torch.Tensor:
    """The candidate index (``[M]``, into the n rows) minimizing the Krum
    score; candidates are the neighbors only, self is not one (Eq. 12)."""
    mask = mask.bool()
    ranks = max(_widest(mask) - b - 2, 1)
    scores = krum_scores(d2, full, mask.sum(dim=1), b, ranks)
    return torch.argmin(torch.where(mask, scores[:, :-1], torch.inf), dim=1)


def bulyan_select(d2: torch.Tensor, mask: torch.Tensor, b: int) -> torch.Tensor:
    """Bulyan's recursive-Krum selection (the reference's
    ``_bulyan_select``): from each node's masked ``[n+1, n+1]`` ``d2``, pick
    ``count - 2b`` neighbors one at a time, each the Krum winner among the
    candidates left; returns the ``[M, n]`` selection mask.  The
    reference's ``fori_loop`` runs n steps of which only the first
    ``count - 2b`` pick; this loop stops after the widest node's last
    pick, and reads the card once, before it."""
    mask = mask.bool()
    m, n = mask.shape
    widest = _widest(mask)
    n_select = mask.sum(dim=1) - 2 * b
    ranks = max(widest - b - 2, 1)
    cand = mask.clone()
    selected = torch.zeros_like(mask)
    one = torch.ones((m, 1), dtype=torch.bool, device=mask.device)
    slots = torch.arange(n, device=mask.device)
    for step in range(max(widest - 2 * b, 0)):
        fm = torch.cat([cand, one], dim=1)
        scores = krum_scores(masked_dists(d2, fm), fm, cand.sum(dim=1), b, ranks)
        i_star = torch.argmin(torch.where(cand, scores[:, :-1], torch.inf), dim=1)
        pick = (slots[None, :] == i_star[:, None]) & (step < n_select)[:, None]
        cand = cand & ~pick
        selected = selected | pick
    return selected


def _dists_of_broadcast(w: torch.Tensor, self_vals: torch.Tensor):
    """One distance matrix per tick over what every node screens: ``w``
    itself when each node's own value is its broadcast row (the identity
    codec), else ``cat([w, self_vals])``; returns it with each node's self
    row index."""
    m = w.shape[0]
    ids = torch.arange(m, device=w.device)
    if self_vals is w:
        return ops.pairwise_sq_dists(w), ids
    return ops.pairwise_sq_dists(torch.cat([w, self_vals], dim=0)), ids + m


def _vector_rule(rule: str, w: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                 self_vals: torch.Tensor, b: int, trimmed_mean: Callable) -> torch.Tensor:
    """BRIDGE-K or BRIDGE-B at every node over the candidate rows ``rows``
    (``[M, n]`` indices into ``w``) under ``mask``; ``trimmed_mean(sel)``
    is Bulyan's last stage over the ``[M, n]`` selection."""
    d2_global, self_rows = _dists_of_broadcast(w, self_vals)
    d2, full = node_dists(d2_global, rows, self_rows, mask)
    if rule == "krum":
        i_star = krum_pick(d2, full, mask, b)
        return w.index_select(0, rows.gather(1, i_star[:, None])[:, 0].long())
    return trimmed_mean(bulyan_select(d2, mask, b))


# ---------------------------------------------------------------------------
# The three entries
# ---------------------------------------------------------------------------


def screen_all(w: torch.Tensor, adjacency: torch.Tensor, *, rule: str, b: int,
               self_vals: torch.Tensor | None = None, recip: bool = False) -> torch.Tensor:
    """Apply ``rule`` at every node; returns the ``[M, d]`` screened y_j.
    ``self_vals`` defaults to ``w`` (each node's own broadcast).  ``recip``
    gives the trimmed mean the reciprocal form of its divisor, which XLA
    writes when the adjacency is closed over and ``b`` is static (ByRDiE);
    the BRIDGE trainer's ``b`` is traced, and it divides."""
    if self_vals is None:
        self_vals = w
    if rule == "trimmed_mean":
        return ops.trimmed_mean(w, adjacency, self_vals, b, recip)
    if rule == "median":
        return ops.median(w, adjacency, self_vals)
    if rule in ("krum", "bulyan"):
        m = w.shape[0]
        rows = torch.arange(m, device=w.device).expand(m, m)
        return _vector_rule(rule, w, rows, adjacency, self_vals, b,
                            lambda sel: ops.trimmed_mean(w, sel, self_vals, b))
    out = _plain_rule(rule, w[None], adjacency, self_vals, b)
    if out is None:
        raise _unknown(rule)
    return out


def screen_views(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, *,
                 rule: str, b: int) -> torch.Tensor:
    """Apply ``rule`` at every node over its own views ``[M, W, d]`` under
    ``mask [M, W]`` — the reference's ``screen_views_banked`` with the mask
    as an operand, so every divisor is a true division.  The trimmed mean
    and the median run the views kernels (on the CPU their plain
    versions), reading the views at their strides.  Krum and Bulyan take
    each node's distances among its own views and itself
    (`ref.pairwise_sq_dists` batched over the nodes), as the reference
    does, on the CPU only: on the card they raise `NotImplementedError`."""
    if rule == "trimmed_mean":
        return ops.views_trimmed_mean(views, mask, self_vals, b)
    if rule == "median":
        return ops.views_median(views, mask, self_vals)
    if rule in VIEWS_DISTANCE_RULES:
        if views.device.type != "cpu":
            raise NotImplementedError(views_distance_refusal(rule))
        stacked, full = _stack_self(views, mask, self_vals)
        d2 = masked_dists(ref.pairwise_sq_dists(stacked), full)
        if rule == "krum":
            i_star = krum_pick(d2, full, mask, b)
            return views.gather(1, i_star[:, None, None].expand(-1, 1, views.shape[2]))[:, 0]
        return ref.trimmed_mean_views(views, bulyan_select(d2, mask, b), self_vals, b)
    out = _plain_rule(rule, views, mask, self_vals, b, folded=False)
    if out is None:
        raise _unknown(rule)
    return out


def screen_gathered(w: torch.Tensor, table: NeighborTable, *, rule: str, b: int,
                    self_vals: torch.Tensor | None = None) -> torch.Tensor:
    """Apply ``rule`` at every node over the broadcast rows its table slots
    name; returns the ``[M, d]`` screened y_j.  ``self_vals`` defaults to
    ``w``.  Slots hold ascending node ids, so Krum's and Bulyan's picks,
    taken from the same distance matrix as on the dense layout, are the
    dense layout's bit for bit; the plain rules read the gathered
    ``[M, K, d]`` views (padded slots hold a real row, masked)."""
    if self_vals is None:
        self_vals = w
    if rule == "trimmed_mean":
        return ops.gather_trimmed_mean(w, table.safe_idx, table.valid_dev, self_vals, b)
    if rule == "median":
        return ops.gather_median(w, table.safe_idx, table.valid_dev, self_vals)
    if rule in ("krum", "bulyan"):
        return _vector_rule(rule, w, table.safe_idx, table.valid_dev, self_vals, b,
                            lambda sel: ops.gather_trimmed_mean(w, table.safe_idx, sel, self_vals, b))
    if rule not in RULES:
        raise _unknown(rule)
    return _plain_rule(rule, table.gather_rows(w), table.valid_dev, self_vals, b)
