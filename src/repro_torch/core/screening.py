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

The experiment axis (the batched grids, `repro_torch.sim.engine`):
`screen_all` and `screen_gathered` also take ``w`` and ``self_vals``
``[E, M, d]`` over one shared adjacency or table, with ``b`` an int or a
tuple of E per-experiment bounds (the reference's ``CellParams.b``), and
screen every experiment in one launch of each kernel the rule runs; each
experiment's output equals its own ``[M, d]`` call bit for bit.
`screen_all_banked`, `screen_gathered_banked` and `screen_views_banked`
choose the rule per experiment from a static bank: each rule runs once,
over the experiments that chose it, and the outputs are scattered back in
order.

The rules, by what runs them on the card:

* ``trimmed_mean`` (BRIDGE-T) and ``median`` (BRIDGE-M) go through the
  screening kernels of `repro_torch.kernels.ops` and never form
  ``[M, M, d]`` or ``[M, K, d]`` on the card;
  On the views, BRIDGE-T and BRIDGE-M run the views kernels
  (``ops.views_trimmed_mean``, ``ops.views_median``);
* ``krum`` (BRIDGE-K, Eq. 12) and ``bulyan`` (BRIDGE-B) take their
  distances from the pairwise-distance kernel, computed once per tick
  over the broadcast (and the nodes' own values where a lossy codec makes
  them differ; over the experiment axis its batched form, one launch for
  every experiment) and gathered per node; Krum's scores and Bulyan's
  recursive selection are plain PyTorch batched over the nodes (and the
  experiments), and Bulyan's last stage is the trimmed-mean kernel over the
  selected set.  On the views each node takes its distances among its own
  ``W + 1`` views and itself from the batched distance kernel, the batch
  axis the node (``[M, W, d]`` read at its strides, the node's own value
  appended as the last row), and Bulyan's last stage is the views
  trimmed-mean kernel over its selection;
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

import functools
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.analysis.contracts import Contract
from repro_torch.core.neighbors import NeighborTable
# the reference's `screening.fence`: a value rounded to float32 before its
# consumer, at a named site (`repro_torch.analysis.fence` counts the sites)
from repro_torch.fence import fence  # noqa: F401
from repro_torch.kernels import autograd as grad_ops
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


def min_neighbors(rule: str, b: int) -> int:
    try:
        return MIN_NEIGHBORS[rule](b)
    except KeyError:
        raise ValueError(
            f"unknown screening rule {rule!r}; options: {sorted(MIN_NEIGHBORS)}") from None


def min_neighbors_banked(rules, rule_idx, b) -> np.ndarray:
    """Table-II minimum of each experiment's rule, chosen by ``rule_idx``
    (``[E]`` indices into the static bank ``rules``) at its bound ``b``
    (an int or ``[E]``): the reference's ``min_neighbors_banked`` over the
    experiment axis, on the host."""
    idx = np.asarray(rule_idx, np.int64).reshape(-1)
    bs = np.broadcast_to(np.asarray(b, np.int64), idx.shape)
    return np.asarray([min_neighbors(rules[i], int(bb)) for i, bb in zip(idx, bs, strict=True)],
                      np.int64)


# ---------------------------------------------------------------------------
# Per-experiment Byzantine bounds
# ---------------------------------------------------------------------------


def bound_min(b) -> int:
    """The smallest bound of ``b`` (an int, or a tuple of E)."""
    return int(b) if isinstance(b, (int, np.integer)) else min(int(x) for x in b)


@functools.lru_cache(maxsize=256)
def _bound_tensor(b: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(b, dtype=torch.int32, device=device)


def bound_arg(b, device: torch.device):
    """``b`` as the kernels take it: an int when every experiment shares it,
    else the int32 ``[E]`` tensor on ``device`` (made once per distinct
    tuple and device)."""
    if isinstance(b, (int, np.integer)):
        return int(b)
    b = tuple(int(x) for x in b)
    if len(set(b)) == 1:
        return b[0]
    return _bound_tensor(b, torch.device(device))


def _select(b, cells):
    """The bounds of the experiments ``cells`` (host indices)."""
    return b if isinstance(b, (int, np.integer)) else tuple(b[int(i)] for i in cells)


def _unknown(rule: str) -> ValueError:
    return ValueError(f"unknown screening rule {rule!r}; options: {list(RULES)}")


def _divide(total: torch.Tensor, count: torch.Tensor, folded: bool) -> torch.Tensor:
    """``total [..., M, d] / count [..., M]``: a true division, or
    (``folded``) a multiply by the float32 reciprocal, which XLA writes when
    the divisor folds to a constant."""
    den = count.to(total.dtype)[..., None]
    return total * (1.0 / den) if folded else total / den


def _bcol(b, device) -> torch.Tensor | int:
    """``b`` against per-node counts ``[M]`` or ``[E, M]``: an int, or the
    per-experiment bounds as an ``[E, 1]`` tensor."""
    arg = bound_arg(b, device)
    return arg if isinstance(arg, int) else arg.to(torch.int64)[:, None]


# ---------------------------------------------------------------------------
# Coordinate-wise and averaging rules over views [(E,) M or 1, n, d]
# ---------------------------------------------------------------------------
#
# Every step is elementwise, per column or a left-to-right chain over the
# view axis (-2), so a leading experiment axis (views ``[E, M or 1, n, d]``,
# ``self_vals [E, M, d]``, a mask ``[M, n]`` shared by all) computes each
# experiment as its own call does.


def _stack_self(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor):
    """The reference's ``stacked = [values; self]`` per node
    (``[.., M, n + 1, d]``) and ``full_mask = [mask; True]``
    (``[M, n + 1]``)."""
    n = mask.shape[-1]
    stacked = torch.cat([views.expand(*self_vals.shape[:-1], n, views.shape[-1]),
                         self_vals[..., None, :]], dim=-2)
    ones = torch.ones((*mask.shape[:-1], 1), dtype=torch.bool, device=mask.device)
    return stacked, torch.cat([mask.bool(), ones], dim=-1)


def mean_views(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, *,
               folded: bool = True) -> torch.Tensor:
    """DGD neighbor averaging over N_j and j: the masked rows summed in row
    order, plus self, over ``count + 1`` (no NaN guard, as in the
    reference)."""
    mask = mask.bool()
    total = ref.sum_rows(torch.where(mask[..., None], views, 0.0), dim=-2) + self_vals
    return _divide(total, mask.sum(dim=-1) + 1, folded)


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
    y = _divide(ref.sum_rows_mat(stacked * fm[..., None], dim=-2), full.sum(dim=-1), folded)
    for _ in range(iters):
        diff = stacked - y[..., None, :]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)
        wts = fm / dist
        y = ref.sum_rows_mat(stacked * wts[..., None], dim=-2) / ref.sum_rows(wts, dim=-1)[..., None]
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
    delta = views - self_vals[..., None, :]
    nrm = torch.sqrt(torch.sum(delta * delta, dim=-1, keepdim=True) + 1e-12)
    clipped = delta * torch.clamp(tau / nrm, max=1.0)
    total = ref.sum_rows_mat(torch.where(mask[..., None], clipped, 0.0), dim=-2)
    count = torch.clamp(mask.sum(dim=-1), min=1).to(views.dtype)[..., None]
    if not folded:
        return self_vals + total / count
    return ref.fma_f32(total, (1.0 / count).expand_as(total).contiguous(), self_vals)


def _weights(mask: torch.Tensor, weights: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    return torch.ones(mask.shape, dtype=dtype, device=mask.device) if weights is None \
        else weights.to(dtype)


def rep_trimmed_mean(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, b, *,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """Reputation-weighted BRIDGE-T (the reference's ``rep_trimmed_mean``):
    per coordinate, keep the values between the ``b_eff``-th smallest and
    largest (ties included), then ``(sum w_i v_i + self) / (sum w_i + 1)``
    over the kept ones, ``weights [M, n]`` defaulting to 1.  The
    reference's NaN anchor (``where(min(order) == min(order), y, 0)``) is
    an XLA scheduling device that never fires, since the sorted values are
    NaN-free; it is left out."""
    mask = mask.bool()
    masked, kept = _rep_window(views, mask, self_vals, b)
    wk = torch.where(kept, _weights(mask, weights, views.dtype)[..., None], 0.0)
    total = ref.sum_rows_mat(wk * torch.where(kept, masked, 0.0), dim=-2) + self_vals
    return total / (ref.sum_rows_mat(wk, dim=-2) + 1.0)


def _rep_window(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, b):
    """The rep rules' kept window (the reference's ``_rep_trim_window``):
    ``(masked, kept)``, ``kept`` the masked values between the ``b_eff``-th
    order statistic and rank ``max(count - b_eff - 1, b_eff)``, ties
    included."""
    count = mask.sum(dim=-1)
    b_eff = ref.effective_trim(bound_arg(b, views.device), count)
    masked = torch.where(mask[..., None], ref.sanitize(views), torch.inf)
    order = torch.sort(masked, dim=-2).values
    d = self_vals.shape[-1]
    lead = self_vals.shape[:-1]
    at = lambda r: r.expand(lead)[..., None, None].expand(*lead, 1, d)
    lo = order.gather(-2, at(b_eff))
    hi = order.gather(-2, at(torch.maximum(count - b_eff - 1, b_eff)))
    return masked, mask[..., None] & (masked >= lo) & (masked <= hi)


def rep_median(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, *,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Reputation-weighted coordinate median (the reference's
    ``rep_median``): per coordinate, the smallest value whose cumulative
    weight reaches half the total (self weighs 1, masked rows 0).  Ties
    keep row order (``argsort(stable=True)``, as ``jnp.argsort``)."""
    stacked, full = _stack_self(views, mask, self_vals)
    w = torch.where(mask.bool(), _weights(mask, weights, views.dtype), 0.0)
    wfull = torch.cat([w, torch.ones_like(w[..., :1])], dim=-1)
    sv = torch.where(full[..., None], ref.sanitize(stacked), torch.inf)
    order_idx = torch.argsort(sv, dim=-2, stable=True)
    sorted_vals = sv.gather(-2, order_idx)
    cum = torch.cumsum(wfull[..., None].expand_as(sv).gather(-2, order_idx), dim=-2)
    first = torch.argmax((cum >= 0.5 * cum[..., -1:, :]).to(torch.uint8), dim=-2)
    return sorted_vals.gather(-2, first[..., None, :])[..., 0, :]


def _plain_rule(rule: str, views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                b, *, folded: bool = True) -> torch.Tensor | None:
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
# Coordinate streaming (the reference's ``screen_chunk``)
# ---------------------------------------------------------------------------


def _streams(rule: str, d: int, chunk: int | None) -> bool:
    """True when the reference streams coordinate chunks: any rule but
    Krum and Bulyan once ``d > chunk``."""
    return rule not in ("krum", "bulyan") and chunk is not None and d > chunk


# Rules whose output on a coordinate block equals the same block of the
# full-d output, the block-streaming contract of `repro_torch.stream`.
# geomedian's Weiszfeld weights and clipped_mean's radii are functions of
# full-vector norms, so chunking changes their result (the reference
# returns that changed result past ``screen_chunk``); these rules are per
# coordinate, so block results are bit for bit the whole ones.
STREAMABLE_RULES: frozenset = frozenset(
    {"trimmed_mean", "median", "mean", "rep_trimmed_mean", "rep_median"})

# The complement, spelled out rather than computed (the reference's
# `STREAM_REJECTED_RULES`): `repro_torch.analysis.lint` checks that the two
# sets partition RULES exactly, so a new rule forces an explicit
# streamability decision.
STREAM_REJECTED_RULES: frozenset = frozenset(
    {"krum", "bulyan", "geomedian", "clipped_mean"})

# The rules the port streams per node and chunk past ``screen_chunk``: the
# plain ones.  BRIDGE-T and BRIDGE-M run whole through the kernels, which
# never form ``[M, M+1, d]`` (they are coordinate-wise, so whole equals
# chunked bit for bit); Krum and Bulyan ignore the chunk, as there.
_CHUNKED_PLAIN = frozenset({"mean", "geomedian", "clipped_mean", "rep_trimmed_mean",
                            "rep_median"})


def check_streamable(rules) -> None:
    """Raise for rules whose blockwise result differs from the whole one
    (`repro_torch.stream` refuses them instead of changing the rule)."""
    bad = [r for r in rules if r not in STREAMABLE_RULES]
    if bad:
        raise ValueError(
            f"rules {bad} are not coordinate-decomposable and cannot stream over parameter "
            f"blocks (repro_torch.stream); streamable rules: {sorted(STREAMABLE_RULES)}")


def check_decide_streams(rules, d: int, chunk: int | None) -> None:
    """Raise where the reference does: the decision path evaluates rules
    unchunked, so forensics or trust where streaming would engage is an
    error."""
    bad = [r for r in rules if _streams(r, d, chunk)]
    if bad:
        raise ValueError(
            f"screening forensics cannot stream coordinates: rules {bad} at d={d} engage "
            f"screen_chunk={chunk}; raise screen_chunk above d or set "
            f"TraceSpec(forensics=False)")


def _chunked(rule: str, rows_of: Callable, mask: torch.Tensor, self_vals: torch.Tensor, b,
             chunk: int) -> torch.Tensor:
    """A plain rule node by node and ``chunk`` coordinates at a time, the
    reference's streamed ``_apply_rule``: node j of ``self_vals [N, d]``
    screens ``rows_of(j) [n, d]`` under ``mask[j]`` (``mask [N, n]``) at
    bound ``b`` (an int), one ``[n + 1, chunk]`` block at a time; the last
    block takes the tail's exact width (the reference's zero padding adds
    nothing to a norm or a column).  The reference maps the nodes with
    ``lax.map``, whose mask row is an operand, not a constant, so every
    divisor is a true division here."""
    out = torch.empty_like(self_vals)
    d = self_vals.shape[-1]
    for j in range(self_vals.shape[0]):
        rows = rows_of(j)
        for lo in range(0, d, chunk):
            hi = min(lo + chunk, d)
            out[j, lo:hi] = _plain_rule(rule, rows[None, :, lo:hi], mask[j:j + 1],
                                        self_vals[j:j + 1, lo:hi], b, folded=False)[0]
    return out


def _chunked_cells(rule: str, w: torch.Tensor, rows_of: Callable, mask: torch.Tensor,
                   self_vals: torch.Tensor, b, chunk: int) -> torch.Tensor:
    """`_chunked` over the cells of ``self_vals [E, M, d]``: ``rows_of(e,
    j)`` node j's rows in cell e, ``mask`` ``[M, n]`` or ``[E, M, n]``,
    ``b`` an int or E bounds."""
    bs = np.broadcast_to(np.asarray(b, np.int64), (self_vals.shape[0],))
    return torch.stack([
        _chunked(rule, lambda j, e=e: rows_of(e, j), mask if mask.ndim == 2 else mask[e],
                 self_vals[e], int(bs[e]), chunk)
        for e in range(self_vals.shape[0])])


# ---------------------------------------------------------------------------
# Vector rules (BRIDGE-K, BRIDGE-B) over per-node distance matrices
# ---------------------------------------------------------------------------


def masked_dists(d2: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``+inf`` off the valid pairs of each node's ``[n+1, n+1]`` matrix
    (the reference's ``pairwise_sq_dists`` masking)."""
    return torch.where(full[..., :, None] & full[..., None, :], d2, torch.inf)


def node_dists(d2_global: torch.Tensor, rows: torch.Tensor, self_rows: torch.Tensor,
               mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Node j's ``[n+1, n+1]`` distance matrix among its candidate rows
    ``rows[j]`` (``[M, n]`` indices into the global matrix) and itself
    (``self_rows[j]``, last), gathered from the tick's ``d2_global``
    (``[E, N, N]``, one an experiment) and masked; returns it
    (``[E, M, n+1, n+1]``) with the full mask ``[mask; True]``."""
    idx = torch.cat([rows, self_rows[:, None]], dim=1).long()
    d2 = d2_global[:, idx[:, :, None], idx[:, None, :]]
    full = torch.cat([mask.bool(), torch.ones_like(mask[..., :1], dtype=torch.bool)], dim=-1)
    return masked_dists(d2, full), full


def krum_scores(d2: torch.Tensor, full: torch.Tensor, count: torch.Tensor, b,
                ranks: int) -> torch.Tensor:
    """Krum score of every candidate row of every node's masked ``d2``
    (``[.., M, n1, n1]``): the sum of its ``max(count - b - 2, 1)`` smallest
    distances to the others, in rank order (`ref.sum_rows`); ``+inf`` for
    invalid rows (the reference's ``_krum_scores``).  ``b`` is an int or the
    experiments' ``[E, 1]`` bounds.  The chain stops after ``ranks`` ranks,
    a bound on every node's taken count known to the caller without reading
    the card: the ranks past it add ``+0.0``, which leaves a sum of
    distances (never ``-0``) unchanged."""
    n1 = d2.shape[-1]
    eye = torch.eye(n1, dtype=torch.bool, device=d2.device)
    order = torch.sort(torch.where(eye, torch.inf, d2), dim=-1).values
    take = torch.clamp(count - b - 2, min=1)
    kept = torch.where(torch.arange(n1, device=d2.device) < take[..., None, None], order, 0.0)
    if n1 <= ref.MAX_EXACT_ROWS:
        kept = kept[..., :ranks]
    return torch.where(full, ref.sum_rows(kept, dim=-1), torch.inf)


def _widest(mask: torch.Tensor) -> int:
    """The largest in-degree of ``mask [.., M, n]`` (one read from the card)."""
    return int(mask.sum(dim=-1).max()) if mask.numel() else 0


def krum_pick(d2: torch.Tensor, full: torch.Tensor, mask: torch.Tensor, b) -> torch.Tensor:
    """The candidate index (``[.., M]``, into the n rows) minimizing the
    Krum score; candidates are the neighbors only, self is not one
    (Eq. 12).  ``b`` an int or a tuple of per-experiment bounds."""
    mask = mask.bool()
    ranks = max(_widest(mask) - bound_min(b) - 2, 1)
    scores = krum_scores(d2, full, mask.sum(dim=-1), _bcol(b, d2.device), ranks)
    return torch.argmin(torch.where(mask, scores[..., :-1], torch.inf), dim=-1)


def bulyan_select(d2: torch.Tensor, mask: torch.Tensor, b) -> torch.Tensor:
    """Bulyan's recursive-Krum selection (the reference's
    ``_bulyan_select``): from each node's masked ``[n+1, n+1]`` ``d2``
    (``[.., M, n+1, n+1]``), pick ``count - 2b`` neighbors one at a time,
    each the Krum winner among the candidates left; returns the
    ``[.., M, n]`` selection mask.  The reference's ``fori_loop`` runs n
    steps of which only the first ``count - 2b`` pick; this loop stops
    after the widest node's last pick under the smallest bound, and reads
    the card once, before it."""
    mask = mask.bool()
    n = mask.shape[-1]
    lead = d2.shape[:-2]
    widest = _widest(mask)
    bcol = _bcol(b, d2.device)
    n_select = mask.sum(dim=-1) - 2 * bcol
    ranks = max(widest - bound_min(b) - 2, 1)
    cand = mask.expand(*lead, n).clone()
    selected = torch.zeros_like(cand)
    one = torch.ones((*lead, 1), dtype=torch.bool, device=mask.device)
    slots = torch.arange(n, device=mask.device)
    for step in range(max(widest - 2 * bound_min(b), 0)):
        fm = torch.cat([cand, one], dim=-1)
        scores = krum_scores(masked_dists(d2, fm), fm, cand.sum(dim=-1), bcol, ranks)
        i_star = torch.argmin(torch.where(cand, scores[..., :-1], torch.inf), dim=-1)
        pick = (slots == i_star[..., None]) & (step < n_select)[..., None]
        cand = cand & ~pick
        selected = selected | pick
    return selected


def _dists(x: torch.Tensor) -> torch.Tensor:
    """The distance kernel over ``x [E, N, d]``: its unbatched entry for one
    experiment (the trainer's), the batched one, one launch, for E."""
    if x.shape[0] == 1:
        return ops.pairwise_sq_dists(x[0].contiguous())[None]
    return ops.pairwise_sq_dists_batched(x)


def _dists_of_broadcast(w: torch.Tensor, self_vals: torch.Tensor):
    """One distance matrix per tick and experiment over what every node
    screens: ``w [E, M, d]`` itself when each node's own value is its
    broadcast row (the identity codec), else ``cat([w, self_vals])``;
    returns it with each node's self row index."""
    m = w.shape[-2]
    ids = torch.arange(m, device=w.device)
    if self_vals is w:
        return _dists(w), ids
    return _dists(torch.cat([w, self_vals], dim=-2)), ids + m


def _pick_rows(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row ``ids[e, j]`` of experiment e's ``w [E, M, d]`` for every node."""
    e, m, d = w.shape
    flat = ids + (torch.arange(e, device=w.device) * m)[:, None]
    return w.reshape(e * m, d).index_select(0, flat.reshape(-1)).reshape(e, m, d)


def _vector_rule(rule: str, w: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                 self_vals: torch.Tensor, b, trimmed_mean: Callable) -> torch.Tensor:
    """BRIDGE-K or BRIDGE-B at every node of every experiment (``w``
    ``[E, M, d]``) over the candidate rows ``rows`` (``[M, n]`` indices into
    ``w``) under ``mask``; ``trimmed_mean(sel)`` is Bulyan's last stage over
    the ``[E, M, n]`` selection."""
    pick = _vector_pick(rule, w, rows, mask, self_vals, b)
    if rule == "krum":
        return _krum_rows(w, rows, pick)
    return trimmed_mean(pick)


def _vector_pick(rule: str, w: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                 self_vals: torch.Tensor, b) -> torch.Tensor:
    """Krum's pick ``[E, M]`` (an index into each node's n candidates) or
    Bulyan's selection ``[E, M, n]`` over the candidate rows ``rows`` of
    ``w [E, M, d]``, from the tick's distance matrix."""
    with torch.no_grad():  # the distances only pick rows; gradients flow through the picks
        same = self_vals is w
        w_d = w.detach()
        d2_global, self_rows = _dists_of_broadcast(w_d, w_d if same else self_vals.detach())
        d2, full = node_dists(d2_global, rows, self_rows, mask)
        if rule == "krum":
            return krum_pick(d2, full, mask, b)
        return bulyan_select(d2, mask, b)


def _krum_rows(w: torch.Tensor, rows: torch.Tensor, i_star: torch.Tensor) -> torch.Tensor:
    """Row ``rows[j, i_star[e, j]]`` of experiment e's ``w`` for every node."""
    ids = rows.long()[None].expand(*i_star.shape, rows.shape[1]).gather(-1, i_star[..., None])
    return _pick_rows(w, ids[..., 0])


# ---------------------------------------------------------------------------
# The entries
# ---------------------------------------------------------------------------


def _batched(w: torch.Tensor, self_vals: torch.Tensor | None):
    """``(w, self_vals)`` with the experiment axis (``[M, d]`` -> ``[1, M, d]``)
    and whether it was added."""
    if self_vals is None:
        self_vals = w
    if w.ndim == 3:
        return w, self_vals, False
    same = self_vals is w
    w = w[None]
    return w, (w if same else self_vals[None]), True


def screen_all(w: torch.Tensor, adjacency: torch.Tensor, *, rule: str, b,
               self_vals: torch.Tensor | None = None, recip: bool = False) -> torch.Tensor:
    """Apply ``rule`` at every node; returns the ``[M, d]`` screened y_j
    (``[E, M, d]`` for ``w [E, M, d]``, ``b`` then an int or E bounds).
    ``self_vals`` defaults to ``w`` (each node's own broadcast).  ``recip``
    gives the trimmed mean the reciprocal form of its divisor, which XLA
    writes when the adjacency is closed over and ``b`` is static (ByRDiE);
    the BRIDGE trainer's ``b`` is traced, and it divides."""
    w, self_vals, added = _batched(w, self_vals)
    y = _screen_all(w, adjacency, rule, b, self_vals, recip)
    return y[0] if added else y


def _screen_all(w, adjacency, rule, b, self_vals, recip=False, chunk=None):
    bk = bound_arg(b, w.device)
    if rule == "trimmed_mean":
        return grad_ops.trimmed_mean(w, adjacency, self_vals, bk, recip)
    if rule == "median":
        return grad_ops.median(w, adjacency, self_vals)
    if rule in ("krum", "bulyan"):
        m = w.shape[-2]
        rows = torch.arange(m, device=w.device).expand(m, m)
        return _vector_rule(rule, w, rows, adjacency, self_vals, b,
                            lambda sel: grad_ops.trimmed_mean(w, sel, self_vals, bk))
    if rule in _CHUNKED_PLAIN and _streams(rule, w.shape[-1], chunk):
        return _chunked_cells(rule, w, lambda e, j: w[e], adjacency.bool(), self_vals, b, chunk)
    out = _plain_rule(rule, w.unsqueeze(-3), adjacency, self_vals, b)
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
    each node's distances among its own views and itself from the batched
    distance kernel (batch = node, the views read in place), and Bulyan
    ends in the views trimmed-mean kernel over its selection.  The one-cell
    form of `screen_views_banked`."""
    return _screen_views(rule, views[None], mask, self_vals[None], b)[0]


def _node_views(views: torch.Tensor) -> torch.Tensor:
    """The views ``[E, M, W, d]`` as ``[E M, W, d]``, the batched distance
    kernel's elements, in place: a cell's nodes at one stride, whatever the
    receiver stride (0 included) when E = 1."""
    e, m, w_, d = views.shape
    try:
        return views.view(e * m, w_, d)
    except RuntimeError:
        raise ValueError(f"views of strides {views.stride()} do not flatten to [E M, W, d] in "
                         f"place") from None


def _views_pick(rule: str, views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                b) -> tuple[torch.Tensor, torch.Tensor]:
    """Krum's pick (``[E, M]``) or Bulyan's selection (``[E, M, W]``) of
    every node over its views ``[E, M, W, d]`` and itself, from the batched
    distance kernel (batch = node, the views read in place); returned with
    the mask expanded to ``[E, M, W]``."""
    e, m, w_, d = views.shape
    mk = mask.bool().expand(e, m, w_)
    full = torch.cat([mk, torch.ones((e, m, 1), dtype=torch.bool, device=mk.device)], dim=-1)
    with torch.no_grad():  # the distances only pick rows
        d2 = ops.pairwise_sq_dists_batched(_node_views(views.detach()),
                                           self_vals.detach().reshape(e * m, d))
        d2 = masked_dists(d2.view(e, m, w_ + 1, w_ + 1), full)
        if rule == "krum":
            return mk, krum_pick(d2, full, mk, b)
        return mk, bulyan_select(d2, mk, b).contiguous()


def _views_row(views: torch.Tensor, i_star: torch.Tensor) -> torch.Tensor:
    """View ``i_star[e, j]`` of every node of ``views [E, M, W, d]``."""
    e, m, _, d = views.shape
    return views.gather(2, i_star[..., None, None].expand(e, m, 1, d))[:, :, 0]


def _screen_views(rule: str, views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                  b, chunk: int | None = None) -> torch.Tensor:
    """One rule over the views ``[E, M, W, d]`` of E cells (``mask``
    ``[M, W]`` shared, or ``[E, M, W]``; ``b`` an int or a tuple of E)."""
    bk = bound_arg(b, views.device)
    if rule == "trimmed_mean":
        return grad_ops.views_trimmed_mean(views, mask, self_vals, bk)
    if rule == "median":
        return grad_ops.views_median(views, mask, self_vals)
    if rule == "krum":
        return _views_row(views, _views_pick(rule, views, mask, self_vals, b)[1])
    if rule == "bulyan":
        sel = _views_pick(rule, views, mask, self_vals, b)[1]
        return grad_ops.views_trimmed_mean(views, sel, self_vals, bk)
    if rule not in RULES:
        raise _unknown(rule)
    if rule in _CHUNKED_PLAIN and _streams(rule, views.shape[-1], chunk):
        return _per_bound(lambda v, mk, s, bb, _: _chunked(rule, lambda j: v[j], mk.bool(), s, bb,
                                                           chunk),
                          views, mask, self_vals, b)
    return _per_bound(lambda v, mk, s, bb, _: _plain_rule(rule, v, mk, s, bb, folded=False),
                      views, mask, self_vals, b)


def _scatter(outs, n: int, sel: torch.Tensor, res):
    """Scatter ``res`` (a tensor, or a tuple of them, whose rows are the
    cells ``sel``) into ``outs``, allocated ``[n, ..]`` from the first
    result when None; returns ``outs``."""
    parts = res if isinstance(res, tuple) else (res,)
    if outs is None:
        outs = tuple(p.new_empty((n, *p.shape[1:])) for p in parts)
    for o, p in zip(outs, parts, strict=True):
        o.index_copy_(0, sel, p)
    return outs


def _per_bound(fn: Callable, views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
               b, weights: torch.Tensor | None = None):
    """A plain rule over the views ``[E, M, W, d]`` of E cells, the cells
    of one bound at a time with their nodes stacked: ``fn(views [N, W, d],
    mask [N, W], self_vals [N, d], b, weights [N, W] or None)`` returns a
    tensor or a tuple of them, ``[N, ..]``, scattered back to ``[E, M,
    ..]``."""
    e, m, w_, d = views.shape
    bs = np.broadcast_to(np.asarray(b, np.int64), (e,))
    mk = mask.expand(e, m, w_) if mask.ndim == 2 else mask
    outs = None
    for bb in sorted(set(bs.tolist())):
        cells = np.nonzero(bs == bb)[0]
        sel = torch.as_tensor(cells, device=views.device)
        part = (lambda x: x.index_select(0, sel)) if len(cells) < e else (lambda x: x)
        res = fn(part(views).reshape(-1, w_, d), part(mk).reshape(-1, w_).contiguous(),
                 part(self_vals).reshape(-1, d), int(bb),
                 None if weights is None else part(weights).reshape(-1, w_))
        parts = res if isinstance(res, tuple) else (res,)
        outs = _scatter(outs, e, sel, tuple(p.reshape(len(cells), m, *p.shape[1:])
                                            for p in parts))
    return outs if isinstance(res, tuple) else outs[0]


def screen_gathered(w: torch.Tensor, table: NeighborTable, *, rule: str, b,
                    self_vals: torch.Tensor | None = None) -> torch.Tensor:
    """Apply ``rule`` at every node over the broadcast rows its table slots
    name; returns the ``[M, d]`` screened y_j (``[E, M, d]`` over the
    experiment axis).  ``self_vals`` defaults to ``w``.  Slots hold
    ascending node ids, so Krum's and Bulyan's picks, taken from the same
    distance matrix as on the dense layout, are the dense layout's bit for
    bit; the plain rules read the gathered ``[M, K, d]`` views (padded
    slots hold a real row, masked)."""
    w, self_vals, added = _batched(w, self_vals)
    y = _screen_gathered(w, table, rule, b, self_vals)
    return y[0] if added else y


def _screen_gathered(w, table, rule, b, self_vals, chunk=None):
    bk = bound_arg(b, w.device)
    if rule == "trimmed_mean":
        return grad_ops.gather_trimmed_mean(w, table.safe_idx, table.valid_dev, self_vals, bk)
    if rule == "median":
        return grad_ops.gather_median(w, table.safe_idx, table.valid_dev, self_vals)
    if rule in ("krum", "bulyan"):
        return _vector_rule(rule, w, table.safe_idx, table.valid_dev, self_vals, b,
                            lambda sel: grad_ops.gather_trimmed_mean(w, table.safe_idx, sel,
                                                                     self_vals, bk))
    if rule not in RULES:
        raise _unknown(rule)
    if rule in _CHUNKED_PLAIN and _streams(rule, w.shape[-1], chunk):
        idx = table.safe_idx.long()
        return _chunked_cells(rule, w, lambda e, j: w[e].index_select(0, idx[j]),
                              table.valid_dev.bool(), self_vals, b, chunk)
    return _plain_rule(rule, ref.gather(w, table.safe_idx), table.valid_dev, self_vals, b)


# ---------------------------------------------------------------------------
# Banked dispatch: a rule per experiment from a static bank
# ---------------------------------------------------------------------------


def _banked(screen: Callable, w: torch.Tensor, self_vals: torch.Tensor, rules, rule_idx, b):
    """``screen(rule, w_r, b_r, self_r, cells)`` once per rule of the bank
    over the experiments that chose it (``rule_idx [E]``, host indices;
    ``cells`` their indices on the device, None when all chose one rule),
    its tensor (or tuple of tensors: the decide forms' ``(y, trim)``)
    scattered back in order; one rule for all is a single call."""
    idx = np.asarray(rule_idx, np.int64).reshape(-1)
    if idx.shape[0] != w.shape[0]:
        raise ValueError(f"rule_idx has {idx.shape[0]} entries for {w.shape[0]} experiments")
    used = sorted(set(idx.tolist()))
    if len(used) == 1:
        return screen(rules[used[0]], w, b, self_vals, None)
    outs = None
    same = self_vals is w
    for r in used:
        cells = np.nonzero(idx == r)[0]
        sel = torch.as_tensor(cells, device=w.device)
        w_r = w.index_select(0, sel)
        s_r = w_r if same else self_vals.index_select(0, sel)
        res = screen(rules[r], w_r, _select(b, cells), s_r, sel)
        outs = _scatter(outs, idx.shape[0], sel, res)
    return outs if isinstance(res, tuple) else outs[0]


def screen_all_banked(w: torch.Tensor, adjacency: torch.Tensor, rules, rule_idx, b, *,
                      self_vals: torch.Tensor | None = None,
                      chunk: int | None = None) -> torch.Tensor:
    """`screen_all` over ``w [E, M, d]`` with experiment e screening by
    ``rules[rule_idx[e]]`` at bound ``b[e]`` (the reference's
    ``screen_all_banked`` under its grid's ``vmap``); ``adjacency`` is
    ``[M, M]`` or an experiment's own ``[E, M, M]``.  Past ``chunk``
    coordinates the plain rules stream node by node and chunk by chunk
    (the reference's ``screen_chunk``)."""
    if self_vals is None:
        self_vals = w
    adj_of = lambda cells: (adjacency if adjacency.ndim == 2 or cells is None
                            else adjacency.index_select(0, cells))
    return _banked(lambda rule, w_r, b_r, s_r, cells: _screen_all(w_r, adj_of(cells), rule, b_r,
                                                                  s_r, chunk=chunk),
                   w, self_vals, rules, rule_idx, b)


def screen_gathered_banked(w: torch.Tensor, table: NeighborTable, rules, rule_idx, b, *,
                           self_vals: torch.Tensor | None = None,
                           chunk: int | None = None) -> torch.Tensor:
    """`screen_gathered` over ``w [E, M, d]`` with a rule an experiment from
    the bank (the reference's sparse trainer path, ``screen_views_banked``
    over the table's gathered rows, without forming them); ``chunk`` as in
    `screen_all_banked`."""
    if self_vals is None:
        self_vals = w
    return _banked(lambda rule, w_r, b_r, s_r, _: _screen_gathered(w_r, table, rule, b_r, s_r,
                                                                   chunk=chunk),
                   w, self_vals, rules, rule_idx, b)


def screen_views_banked(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                        rules, rule_idx, b, *, chunk: int | None = None) -> torch.Tensor:
    """`screen_views` over the views ``[E, M, W, d]`` of E cells (a mask
    ``[M, W]`` every cell shares, or ``[E, M, W]``) with a rule and a bound
    ``b[e]`` a cell: each rule of the bank runs once over the cells that
    chose it, whatever their bounds (the views kernels and Bulyan's last
    stage take them per cell; the distance kernel takes the cells' nodes as
    its batch, ``[E M, W, d]`` in place), and the outputs are scattered
    back.  One rule for all reads the views at their strides, a receiver
    stride of 0 included.  ``chunk`` as in `screen_all_banked`."""
    if mask.ndim == 3 and mask.shape[0] > 1 and mask.stride(0) == 0:
        mask = mask[0]  # one mask every cell shares, expanded
    return _banked(lambda rule, v_r, b_r, s_r, cells: _screen_views(
        rule, v_r, mask if mask.ndim == 2 or cells is None else mask.index_select(0, cells),
        s_r, b_r, chunk), views, self_vals, rules, rule_idx, b)


# ---------------------------------------------------------------------------
# Decision twins (the trace's forensics and the trust layer's evidence)
# ---------------------------------------------------------------------------
#
# Each `<rule>_with_decisions` returns ``(y, trim)``: ``y`` the plain rule's
# output bit for bit (the trace-inertness contract) and ``trim [.., M, n]``
# the fraction of the coordinates on which node j excluded row i from its
# aggregate, 0 for rows off its mask (0 / 1 for the vector rules); the
# coordinate-wise rules decide on the columns 0, s, 2s, .. (``decide_stride``
# s).  They take the views form: values ``[.., M or 1, n, d]`` (one block a
# node, or one every node shares) under ``mask [.., M, n]``.  The trimmed
# mean and the median run the screening kernels' decide form
# (`repro_torch.kernels.screen_decide`: the views kernels here, the dense and
# the gather kernels through the dispatchers below); the rest are plain
# PyTorch.

# Rules that take per-edge reputation weights (the trust layer's
# `edge_weights`); the rest ignore the operand, and eviction reaches them
# through the mask.
WEIGHTED_RULES: frozenset = frozenset({"rep_trimmed_mean", "rep_median"})


def _zeros_trim(mask: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    return torch.zeros((*self_vals.shape[:-1], mask.shape[-1]), dtype=torch.float32,
                       device=self_vals.device)


def _node_axis(views: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """Views every node shares (``[.., 1, n, d]``) expanded to one block a
    node (receiver stride 0), as the views kernels take them."""
    return views.expand(*self_vals.shape[:-1], *views.shape[-2:])


def trimmed_mean_with_decisions(views, mask, self_vals, b, *, decide_stride=1):
    """BRIDGE-T with the per-edge fractions outside its kept window
    ``[o[b_eff], o[max(count - b_eff - 1, b_eff)]]`` (ties kept): the views
    kernels' decide form."""
    return ops.views_trimmed_mean_decide(_node_axis(views, self_vals), mask, self_vals,
                                         bound_arg(b, views.device), decide_stride)


def coordinate_median_with_decisions(views, mask, self_vals, b=0, *, decide_stride=1):
    """BRIDGE-M with the per-edge fractions outside its two middle order
    statistics (self included in the sort, its own decision dropped)."""
    return ops.views_median_decide(_node_axis(views, self_vals), mask, self_vals, decide_stride)


def krum_with_decisions(views, mask, self_vals, b, *, decide_stride=1):
    """BRIDGE-K with a whole-vector decision: every masked row but the pick
    is trimmed (1), the pick kept (0)."""
    views = _node_axis(views, self_vals)
    lead = views.shape[:-3]
    v4 = views.reshape(-1, *views.shape[-3:])
    mk, i_star = _views_pick("krum", v4, mask.reshape(-1, *mask.shape[-2:]) if mask.ndim > 2
                             else mask, self_vals.reshape(-1, *self_vals.shape[-2:]), b)
    y = _views_row(v4, i_star).reshape(self_vals.shape)
    return y, _krum_trim(mk, i_star).reshape(*lead, *mk.shape[-2:])


def _krum_trim(mask: torch.Tensor, i_star: torch.Tensor) -> torch.Tensor:
    slots = torch.arange(mask.shape[-1], device=mask.device)
    return (mask & (slots != i_star[..., None])).to(torch.float32)


def _bulyan_trim(mask: torch.Tensor, sel: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """Bulyan's decisions: rows Krum deselected are trimmed outright, the
    rest carry the trimmed mean's fractions over the selection."""
    return torch.where(mask & ~sel, 1.0, inner)


def bulyan_with_decisions(views, mask, self_vals, b, *, decide_stride=1):
    """BRIDGE-B with its decisions: the trimmed mean's decide form over the
    selection, deselected rows trimmed outright."""
    views = _node_axis(views, self_vals)
    lead = views.shape[:-3]
    v4 = views.reshape(-1, *views.shape[-3:])
    s3 = self_vals.reshape(-1, *self_vals.shape[-2:])
    mk, sel = _views_pick("bulyan", v4, mask.reshape(-1, *mask.shape[-2:]) if mask.ndim > 2
                          else mask, s3, b)
    y, inner = ops.views_trimmed_mean_decide(v4, sel, s3, bound_arg(b, views.device),
                                             decide_stride)
    trim = _bulyan_trim(mk, sel, inner)
    return y.reshape(self_vals.shape), trim.reshape(*lead, *mk.shape[-2:])


def geometric_median_with_decisions(views, mask, self_vals, b=0, *, iters: int = 8,
                                    eps: float = 1e-6, decide_stride=1, folded: bool = True):
    """The geometric median with a soft decision: ``clip(1 - med /
    max(dist, 1e-12), 0, 1)`` on masked rows, ``dist`` a row's distance to
    the output and ``med`` the median of the masked distances (the
    reference's; ``torch.sum`` over d sums in its own order, so the
    fractions are within a few ulps of the reference's)."""
    y = geometric_median(views, mask, self_vals, iters=iters, eps=eps, folded=folded)
    mask = mask.bool()
    diff = views - y[..., None, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)
    mask = mask.expand(dist.shape)
    cnt = mask.sum(dim=-1, keepdim=True)
    order = torch.sort(torch.where(mask, dist, torch.inf), dim=-1).values
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), min=0)
    med = 0.5 * (order.gather(-1, lo) + order.gather(-1, hi))
    trim = torch.clamp(1.0 - med / torch.clamp(dist, min=1e-12), 0.0, 1.0)
    return y, torch.where(mask, trim, 0.0).to(torch.float32)


def clipped_mean_with_decisions(views, mask, self_vals, b=0, *, tau: float = 1.0,
                                decide_stride=1, folded: bool = True):
    """Centered clipping with a whole-vector decision: a masked row whose
    delta from self exceeds the ball of radius ``tau`` is trimmed (1)."""
    y = clipped_mean(views, mask, self_vals, tau=tau, folded=folded)
    delta = views - self_vals[..., None, :]
    nrm = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
    return y, (mask.bool() & (nrm > tau)).to(torch.float32)


def mean_with_decisions(views, mask, self_vals, b=0, *, decide_stride=1, folded: bool = True):
    """DGD's mean decides nothing: every fraction 0."""
    return mean_views(views, mask, self_vals, folded=folded), _zeros_trim(mask, self_vals)


def rep_trimmed_mean_with_decisions(views, mask, self_vals, b, *, weights=None,
                                    decide_stride=1):
    """The reputation-weighted trimmed mean with the fractions of masked
    rows outside its kept window (the rule's own ``kept``)."""
    y = rep_trimmed_mean(views, mask, self_vals, b, weights=weights)
    mask = mask.bool()
    _, kept = _rep_window(views, mask, self_vals, b)
    trimmed = mask[..., None] & ~kept[..., ::decide_stride]
    return y, ref.count_fraction(trimmed.sum(dim=-1), -(-views.shape[-1] // decide_stride))


def rep_median_with_decisions(views, mask, self_vals, b=0, *, weights=None, decide_stride=1):
    """The reputation-weighted median with the (unweighted) median's
    decisions: who keeps landing outside the middle ranks is a rank
    property, independent of the weights."""
    y = rep_median(views, mask, self_vals, weights=weights)
    return y, coordinate_median_with_decisions(views, mask, self_vals,
                                               decide_stride=decide_stride)[1]


RULES_WITH_DECISIONS: dict[str, Callable] = {
    "trimmed_mean": trimmed_mean_with_decisions,
    "median": coordinate_median_with_decisions,
    "krum": krum_with_decisions,
    "bulyan": bulyan_with_decisions,
    "geomedian": geometric_median_with_decisions,
    "clipped_mean": clipped_mean_with_decisions,
    "mean": mean_with_decisions,
    "rep_trimmed_mean": rep_trimmed_mean_with_decisions,
    "rep_median": rep_median_with_decisions,
}
_FOLDABLE = ("mean", "geomedian", "clipped_mean")


def _plain_decide(rule: str, views, mask, self_vals, b, stride: int, weights, folded: bool):
    """A rule with no kernel, with its decisions, over views; ``weights``
    reach `WEIGHTED_RULES` only; ``folded`` the averaging rules' divisor
    form (see the module docstring)."""
    fn = RULES_WITH_DECISIONS[rule]
    if rule in WEIGHTED_RULES:
        return fn(views, mask, self_vals, b, weights=weights, decide_stride=stride)
    if rule in _FOLDABLE:
        return fn(views, mask, self_vals, b, decide_stride=stride, folded=folded)
    return fn(views, mask, self_vals, b, decide_stride=stride)


def _decide_all(rule, w, adjacency, b, self_vals, stride, weights, folded):
    bk = bound_arg(b, w.device)
    if rule == "trimmed_mean":
        return ops.trimmed_mean_decide(w, adjacency, self_vals, bk, stride)
    if rule == "median":
        return ops.median_decide(w, adjacency, self_vals, stride)
    if rule == "rep_median":
        return (rep_median(w.unsqueeze(-3), adjacency, self_vals, weights=weights),
                ops.median_decide(w, adjacency, self_vals, stride)[1])
    m = w.shape[-2]
    if rule in ("krum", "bulyan"):
        return _vector_decide(rule, w, torch.arange(m, device=w.device).expand(m, m), adjacency,
                              self_vals, b, lambda sel: ops.trimmed_mean_decide(
                                  w, sel, self_vals, bk, stride))
    if rule not in RULES:
        raise _unknown(rule)
    return _plain_decide(rule, w.unsqueeze(-3), adjacency, self_vals, b, stride, weights, folded)


def _decide_gathered(rule, w, table, valid, b, self_vals, stride, weights, folded):
    bk = bound_arg(b, w.device)
    if rule == "trimmed_mean":
        return ops.gather_trimmed_mean_decide(w, table.safe_idx, valid, self_vals, bk, stride)
    if rule == "median":
        return ops.gather_median_decide(w, table.safe_idx, valid, self_vals, stride)
    if rule == "rep_median":
        return (rep_median(ref.gather(w, table.safe_idx), valid, self_vals, weights=weights),
                ops.gather_median_decide(w, table.safe_idx, valid, self_vals, stride)[1])
    if rule in ("krum", "bulyan"):
        return _vector_decide(rule, w, table.safe_idx, valid, self_vals, b,
                              lambda sel: ops.gather_trimmed_mean_decide(
                                  w, table.safe_idx, sel, self_vals, bk, stride))
    if rule not in RULES:
        raise _unknown(rule)
    return _plain_decide(rule, ref.gather(w, table.safe_idx), valid, self_vals, b, stride,
                         weights, folded)


def _vector_decide(rule, w, rows, mask, self_vals, b, trimmed_mean_decide):
    """BRIDGE-K or BRIDGE-B with decisions over the candidate rows ``rows``
    of ``w [E, M, d]`` (see `_vector_rule`)."""
    pick = _vector_pick(rule, w, rows, mask, self_vals, b)
    mk = mask.bool().expand(*self_vals.shape[:-1], rows.shape[-1])
    if rule == "krum":
        return _krum_rows(w, rows, pick), _krum_trim(mk, pick)
    y, inner = trimmed_mean_decide(pick)
    return y, _bulyan_trim(mk, pick, inner)


def _decide_views(rule, views, mask, self_vals, b, stride, weights):
    """One rule with its decisions over the views ``[E, M, W, d]`` of E
    cells (the reference's operand form: every divisor a true division)."""
    if rule in ("trimmed_mean", "median", "krum", "bulyan"):
        return RULES_WITH_DECISIONS[rule](views, mask, self_vals, b, decide_stride=stride)
    if rule not in RULES:
        raise _unknown(rule)
    # the plain rules as `_screen_views` runs them, so y is its bit for bit
    return _per_bound(lambda v, mk, s, bb, wt: _plain_decide(rule, v, mk, s, bb, stride, wt,
                                                             folded=False),
                      views, mask, self_vals, b, weights)


def _rule_weights(weights: torch.Tensor | None, rule: str, cells) -> torch.Tensor | None:
    """The cells' reputation weights where ``rule`` takes them, else None."""
    if weights is None or rule not in WEIGHTED_RULES:
        return None
    return weights if cells is None else weights.index_select(0, cells)


def screen_all_decide_banked(w: torch.Tensor, adjacency: torch.Tensor, rules, rule_idx, b, *,
                             self_vals: torch.Tensor | None = None, decide_stride: int = 1,
                             weights: torch.Tensor | None = None,
                             folded: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """`screen_all_banked` returning ``(y, trim)``: ``y`` bit for bit the
    plain call's, ``trim [E, M, M]`` the fraction of the coordinates on
    which receiver j excluded sender i this tick (on every
    ``decide_stride``-th one).  ``adjacency`` is ``[M, M]`` or a cell's own
    ``[E, M, M]`` (the trust layer's evictions cleared from it);
    ``weights`` (``[E, M, M]`` reputation rows) reach `WEIGHTED_RULES`
    only.  ``folded=False`` divides the averaging rules' counts, as the
    reference does once the adjacency is a run-time value (trust on)."""
    if self_vals is None:
        self_vals = w
    adj_of = lambda cells: (adjacency if adjacency.ndim == 2 or cells is None
                            else adjacency.index_select(0, cells))
    return _banked(lambda rule, w_r, b_r, s_r, cells: _decide_all(
        rule, w_r, adj_of(cells), b_r, s_r, decide_stride, _rule_weights(weights, rule, cells),
        folded), w, self_vals, rules, rule_idx, b)


def screen_gathered_decide_banked(w: torch.Tensor, table: NeighborTable, rules, rule_idx, b, *,
                                  self_vals: torch.Tensor | None = None,
                                  valid: torch.Tensor | None = None, decide_stride: int = 1,
                                  weights: torch.Tensor | None = None,
                                  folded: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """`screen_gathered_banked` returning ``(y, trim [E, M, K])`` by table
    slot (the reference's ``screen_views_decide_banked`` over the table's
    gathered rows, without forming them).  ``valid`` replaces the table's
    mask, ``[M, K]`` or a cell's own ``[E, M, K]`` (evictions cleared);
    ``weights`` and ``folded`` as in `screen_all_decide_banked`."""
    if self_vals is None:
        self_vals = w
    mask = table.valid_dev if valid is None else valid
    mask_of = lambda cells: mask if mask.ndim == 2 or cells is None else mask.index_select(0, cells)
    return _banked(lambda rule, w_r, b_r, s_r, cells: _decide_gathered(
        rule, w_r, table, mask_of(cells), b_r, s_r, decide_stride,
        _rule_weights(weights, rule, cells), folded), w, self_vals, rules, rule_idx, b)


def screen_views_decide_banked(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                               rules, rule_idx, b, *, decide_stride: int = 1,
                               weights: torch.Tensor | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """`screen_views_banked` returning ``(y, trim [E, M, W])`` by view slot;
    ``weights`` (``[E, M, W]``) reach `WEIGHTED_RULES` only."""
    if mask.ndim == 3 and mask.shape[0] > 1 and mask.stride(0) == 0:
        mask = mask[0]  # one mask every cell shares, expanded
    return _banked(lambda rule, v_r, b_r, s_r, cells: _decide_views(
        rule, v_r, mask if mask.ndim == 2 or cells is None else mask.index_select(0, cells),
        s_r, b_r, decide_stride, _rule_weights(weights, rule, cells)),
        views, self_vals, rules, rule_idx, b)


# ---------------------------------------------------------------------------
# Contracts (`python -m repro_torch.analysis`)
# ---------------------------------------------------------------------------

CONTRACTS: tuple[Contract, ...] = (
    Contract(
        "screening.fence.survives", "fence",
        "every canonical program's tick passes at least min_fences `fence` "
        "sites, the apply's among them, and the apply's result is y - "
        "fence(rho * g) recomputed from its own operands, bit for bit (the "
        "port runs eagerly: no trip-2 loop to find in an HLO, so the sites "
        "are counted at run time and the rounding checked on the values)",
        params=(("min_fences", 1),),
    ),
    Contract(
        "screening.metrics.gradnorm_unfused", "fence",
        "the metrics-on program's tick passes exactly one more fence site "
        "than its metrics-off twin: the gradient norm reads a fenced "
        "gradient, and turning metrics on loses no other site",
        params=(("delta", 1),),
    ),
    Contract(
        "screening.stream.partition", "lint",
        "every rule in RULES sits in exactly one of STREAMABLE_RULES / "
        "STREAM_REJECTED_RULES",
        params=(("check", "stream_partition"),),
    ),
    Contract(
        "screening.registries.complete", "lint",
        "MIN_NEIGHBORS and RULES_WITH_DECISIONS cover exactly RULES; "
        "WEIGHTED_RULES is a subset (the port has no traceable twin of "
        "MIN_NEIGHBORS: its banked minimum maps it on the host)",
        params=(("check", "registry_completeness"),),
    ),
)
