"""Plain PyTorch versions of the kernels.

The screening functions carry the numerics of the rules the reference
trainer runs (`repro.core.screening.trimmed_mean` / ``coordinate_median``
reached through ``screen_all_banked`` or ``screen_views_banked``),
operation for operation:

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
  whenever the divisor is a run-time value, as it is in its trainer; with
  ``recip`` the total is multiplied by the divisor's float32 reciprocal,
  the form XLA folds a constant divisor into (ByRDiE's block screen).

Each rule is written once over rows ``[M or 1, n, d]`` and an ``[M, n]``
mask, and reached three ways: the dense layout (the shared broadcast
``w [M, d]`` and the ``[M, M]`` in-neighbor mask, ``adj[j, i]``: i sends to
j), pre-gathered views ``[M, K, d]`` with their ``[M, K]`` mask, and the
sparse layout (``w`` gathered through a ``[M, K]`` index table, padded
slots masked).  These build the ``[M, n, d]`` tensors the kernels never
form; they are the CPU path and the kernels' yardstick for equality, not a
fast path.

The int8 decode (`dequant`, `dequant_carry`) is that of the reference's
codec (`repro.comm.codec.apply_scales`, `repro.comm.exchange.decode_bank`);
`fma_f32` gives it the single rounding XLA's fused multiply-add has.  The
codeword screens (`dequant_trimmed_mean_dense`, `dequant_median_dense`,
`gather_dequant_trimmed_mean`, `gather_dequant_median`) are `dequant`
followed by the float screens: decode-then-screen, which the fused
kernels equal by construction.

`pairwise_sq_dists` is the plain version of the Krum distance kernel
(`repro.kernels.krum.pairwise_sq_dists_pallas`), and `sum_rows_mat` the
reference's chain for summands that hold a product.
"""
from __future__ import annotations

import numpy as np
import torch

# The reference's bound for the sequential sum / sorting network
# (`repro.core.screening.sum_rows`, ``sort_rows``): above it, sums go through
# a reduction tree whose order nothing else reproduces.
MAX_EXACT_ROWS = 64
# Coordinates per (scale, zero) pair of an int8 codeword (the reference's
# `repro.comm.codec.SCALE_BLOCK`).
SCALE_BLOCK = 128


def sanitize(x: torch.Tensor) -> torch.Tensor:
    """NaN -> +inf, so NaN payloads rank as maximal outliers."""
    return torch.where(torch.isnan(x), torch.inf, x)


def effective_trim(b, count: torch.Tensor) -> torch.Tensor:
    """``min(b, max((count - 1) // 2, 0))`` per node (floor division).
    ``b`` is an int, or an integer tensor ``[E]`` of per-experiment bounds
    against ``count [M]`` or ``[E, M]`` (a negative bound trims nothing)."""
    widest = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0)
    if isinstance(b, torch.Tensor):
        return torch.minimum(torch.clamp(b.to(count.dtype), min=0)[:, None], widest)
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


def sum_rows_mat(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`sum_rows` for summands that contain a product (the reference's
    ``sum_rows_mat``: geomedian's weighted rows, clipped mean's scaled
    deltas, the rep rules' weighted values).  The reference materialises
    the product behind a ``lax.scan`` so that XLA cannot contract it into
    the chain's adds; in eager PyTorch the product is its own kernel and
    already rounded to float32 when it reaches here, so the chain is the
    same left-to-right sum."""
    return sum_rows(x, dim)


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """``[..., n, n]`` squared distances between the rows of ``x [..., n, d]``
    (the reference's ``kernels/ref.py::pairwise_sq_dists_ref`` and the Krum
    kernel `repro.kernels.krum.pairwise_sq_dists_pallas`): the Gram
    ``g = x x^T`` in float32, its upper triangle mirrored so ``d2`` is
    symmetric bit for bit, and ``max(g_ii + g_jj - 2 g_ij, 0)`` with the
    norms taken from the Gram's own diagonal, so ``d2_ii == 0`` exactly for
    a finite row.  The clamp is ``where(v < 0, 0, v)``, which keeps NaN as
    ``jnp.maximum`` does (``clamp_min`` would too, but the CUDA kernel's
    ``v < 0 ? 0 : v`` is the form both share).  The product goes to
    ``torch.matmul``, as the reference leaves it to XLA's dot; its
    summation order is the library's, so ``d2`` matches the reference
    within the float32 dot-product bound, not bit for bit."""
    x = x.to(torch.float32)
    g = torch.matmul(x, x.mT)
    n = g.shape[-1]
    i = torch.arange(n, device=x.device)
    g = torch.where(i[:, None] <= i[None, :], g, g.mT)
    sq = torch.diagonal(g, dim1=-2, dim2=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * g
    return torch.where(d2 < 0, 0.0, d2)


def pairwise_sq_dists_batched(x: torch.Tensor,
                              self_vals: torch.Tensor | None = None) -> torch.Tensor:
    """`pairwise_sq_dists` of each batch element of ``x [B, n, d]``, with
    ``self_vals [B, d]`` (if given) appended as each element's last row:
    the plain version of the batched distance kernel, which forms the
    ``[B, n + 1, d]`` stack the kernel reads in place.  Each element is its
    own unbatched call, so it equals `pairwise_sq_dists` of its rows bit
    for bit whatever B, as the kernel's elements do (a batched product
    may sum in another order than the unbatched one)."""
    if self_vals is not None:
        x = torch.cat([x, self_vals[:, None, :]], dim=1)
    return torch.stack([pairwise_sq_dists(x[i]) for i in range(x.shape[0])])


def trimmed_mean_views(rows: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                       b, recip: bool = False) -> torch.Tensor:
    """BRIDGE-T (Eqs. 7-10) at every node over its views ``rows [M, n, d]``
    (or one ``[1, n, d]`` shared by all) under ``mask [M, n]``: drop the
    ``b_eff`` smallest and largest values per coordinate, add the node's own
    (unsanitized) value, divide by ``count - 2 b_eff + 1`` (``recip``:
    multiply by its float32 reciprocal).

    The experiment axis: ``rows [E, M or 1, n, d]``, ``self_vals [E, M, d]``
    and ``b`` an integer tensor ``[E]`` screen E experiments under one
    shared mask, each as its own unbatched call computes it (every step is
    elementwise or per column)."""
    _, order, count, b_eff = _trim_order(rows, mask, b)
    return _kept_mean(order, count, b_eff, self_vals, recip)


def _kept_mean(order: torch.Tensor, count: torch.Tensor, b_eff: torch.Tensor,
               self_vals: torch.Tensor, recip: bool = False) -> torch.Tensor:
    """Ranks ``[b_eff, count - b_eff)`` of ``order`` summed left to right,
    self added, over ``count - 2 b_eff + 1`` (or times its reciprocal)."""
    idx = torch.arange(order.shape[-2], device=order.device)[:, None]
    keep = (idx >= b_eff[..., None, None]) & (idx < (count - b_eff)[..., None, None])
    total = sum_rows(torch.where(keep, order, 0.0), dim=-2) + self_vals
    den = (count - 2 * b_eff + 1).to(order.dtype)[..., None]
    return total * (1.0 / den) if recip else total / den


def _trim_order(rows: torch.Tensor, mask: torch.Tensor, b):
    """The trimmed mean's sort: ``(masked, order, count, b_eff)`` with
    ``masked`` the sanitized views, +inf off the mask, and ``order`` its
    columns sorted over the view axis."""
    mask = mask.bool()
    count = mask.sum(dim=-1)
    b_eff = effective_trim(b, count)
    masked = torch.where(mask[..., None], sanitize(rows), torch.inf)
    return masked, torch.sort(masked, dim=-2).values, count, b_eff


def _rank(order: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Rank ``r`` (one a node, ``[.., M]``) of each column of ``order``
    ``[.., M, n, d]``: ``[.., M, d]``."""
    lead, d = order.shape[:-2], order.shape[-1]
    return order.gather(-2, r.expand(lead)[..., None, None].expand(*lead, 1, d))[..., 0, :]


def count_fraction(counts: torch.Tensor, ncols: int) -> torch.Tensor:
    """Integer counts of trimmed columns as fractions of the ``ncols``
    columns decided: ``float32(count) * float32(1 / ncols)``, one rounding
    each — the form XLA compiles the reference's ``jnp.mean`` over a static
    width into (``tools/xla_divisor_forms.py``)."""
    # a Python float that holds the float32 reciprocal exactly: the multiply
    # takes it as a kernel argument, with no copy to the card
    return counts.to(torch.float32) * float(np.float32(1.0) / np.float32(ncols))


def kept_window(masked: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                stride: int) -> torch.Tensor:
    """Whether each row's value of the columns ``0, s, 2s, ..`` lies in the
    kept window ``[lo, hi]`` (ties at a boundary kept): ``masked [.., n,
    d]`` against ``lo``, ``hi [.., d]``."""
    s = stride
    return (masked[..., ::s] >= lo[..., None, ::s]) & (masked[..., ::s] <= hi[..., None, ::s])


def trimmed_mean_views_decide(rows: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                              b, stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`trimmed_mean_views` with its decisions (the reference's
    ``trimmed_mean_with_decisions``): ``(y, trim)``, ``y`` the plain
    screen's bit for bit and ``trim [.., M, n]`` the fraction of the
    columns ``0, s, 2s, ..`` on which a masked row's value fell outside the
    kept window ``[o[b_eff], o[max(count - b_eff - 1, b_eff)]]`` of its
    column's order statistics ``o`` (ties kept); 0 off the mask."""
    masked, order, count, b_eff = _trim_order(rows, mask, b)
    y = _kept_mean(order, count, b_eff, self_vals)
    lo = _rank(order, b_eff)
    hi = _rank(order, torch.maximum(count - b_eff - 1, b_eff))
    masked = masked.expand(*lo.shape[:-1], *masked.shape[-2:])
    trimmed = mask.bool()[..., None] & ~kept_window(masked, lo, hi, stride)
    return y, count_fraction(trimmed.sum(dim=-1), -(-rows.shape[-1] // stride))


def _median_order(rows: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor):
    """The median's sort over the masked views and self: ``(masked, order,
    count)``, ``masked`` the sanitized views (+inf off the mask) expanded
    to every node, ``count`` the rows a node sorts (its mask's and self)."""
    mask = mask.bool()
    masked = torch.where(mask[..., None], sanitize(rows), torch.inf)
    masked = masked.expand(*self_vals.shape[:-1], *masked.shape[-2:])
    order = torch.sort(torch.cat([masked, sanitize(self_vals)[..., None, :]], dim=-2),
                       dim=-2).values
    count = (mask.sum(dim=-1) + 1).expand(self_vals.shape[:-1])
    return masked, order, count


def median_views(rows: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """BRIDGE-M (Eq. 11) at every node: the coordinate-wise median over its
    masked views (as in `trimmed_mean_views`, experiment axis included) and
    itself (self joins sanitized); an even count averages the two middle
    order statistics."""
    _, order, count = _median_order(rows, mask, self_vals)
    lo = _rank(order, torch.div(count - 1, 2, rounding_mode="floor"))
    hi = _rank(order, torch.div(count, 2, rounding_mode="floor"))
    return 0.5 * (lo + hi)


def median_views_decide(rows: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                        stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`median_views` with its decisions (the reference's
    ``coordinate_median_with_decisions``): ``trim [.., M, n]`` the fraction
    of the columns ``0, s, 2s, ..`` on which a masked row's value fell
    outside the two middle order statistics of the ``count + 1`` rows, self
    included (ties kept); the self row's own decision is dropped."""
    masked, order, count = _median_order(rows, mask, self_vals)
    lo = _rank(order, torch.div(count - 1, 2, rounding_mode="floor"))
    hi = _rank(order, torch.div(count, 2, rounding_mode="floor"))
    trimmed = mask.bool()[..., None] & ~kept_window(masked, lo, hi, stride)
    return 0.5 * (lo + hi), count_fraction(trimmed.sum(dim=-1), -(-rows.shape[-1] // stride))


def _shared_rows(w: torch.Tensor) -> torch.Tensor:
    """The broadcast ``w [M, d]`` (or ``[E, M, d]``) as the views every node
    shares: ``[1, M, d]`` (``[E, 1, M, d]``)."""
    return w.unsqueeze(-3)


def trimmed_mean_dense(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor,
                       b, recip: bool = False) -> torch.Tensor:
    """`trimmed_mean_views` at every node over the broadcast ``w [M, d]``
    under the in-neighbor mask ``adj [M, M]`` (the experiment axis: ``w``
    and ``self_vals`` ``[E, M, d]``, ``b`` ``[E]``)."""
    return trimmed_mean_views(_shared_rows(w), adj, self_vals, b, recip)


def median_dense(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """`median_views` at every node over the broadcast ``w [M, d]`` (or
    ``[E, M, d]``) under the in-neighbor mask ``adj [M, M]``."""
    return median_views(_shared_rows(w), adj, self_vals)


def trimmed_mean_dense_decide(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor, b,
                              stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`trimmed_mean_views_decide` over the broadcast ``w [M, d]`` (or
    ``[E, M, d]``) under ``adj [M, M]`` (or ``[E, M, M]``, a mask a cell):
    ``trim [.., M, M]``, receiver by sender."""
    return trimmed_mean_views_decide(_shared_rows(w), adj, self_vals, b, stride)


def median_dense_decide(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor,
                        stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`median_views_decide` over the broadcast ``w [M, d]`` (or ``[E, M,
    d]``) under ``adj``."""
    return median_views_decide(_shared_rows(w), adj, self_vals, stride)


def gather(w: torch.Tensor, safe_idx: torch.Tensor) -> torch.Tensor:
    """``[M, K, d]`` (``[E, M, K, d]`` for ``w [E, M, d]``): slot (j, k)
    holds row ``safe_idx[j, k]`` of ``w``."""
    m, k = safe_idx.shape
    rows = w.index_select(-2, safe_idx.reshape(-1).long())
    return rows.reshape(*w.shape[:-2], m, k, w.shape[-1])


def gather_trimmed_mean(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                        self_vals: torch.Tensor, b) -> torch.Tensor:
    """BRIDGE-T on the sparse layout: node j screens the rows of ``w``
    named by ``safe_idx[j]`` where ``valid[j]`` (padded slots are +inf
    sentinels), in slot order; ``[E, M, d]`` operands and ``b [E]`` for
    the experiment axis."""
    return trimmed_mean_views(gather(w, safe_idx), valid, self_vals, b)


def gather_median(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                  self_vals: torch.Tensor) -> torch.Tensor:
    """BRIDGE-M on the sparse layout (see `gather_trimmed_mean`)."""
    return median_views(gather(w, safe_idx), valid, self_vals)


def gather_trimmed_mean_decide(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                               self_vals: torch.Tensor, b,
                               stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`gather_trimmed_mean` with its decisions: ``trim [.., M, K]`` by
    table slot (``valid`` ``[M, K]`` or ``[E, M, K]``, a mask a cell)."""
    return trimmed_mean_views_decide(gather(w, safe_idx), valid, self_vals, b, stride)


def gather_median_decide(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                         self_vals: torch.Tensor,
                         stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`gather_median` with its decisions, ``trim [.., M, K]`` by slot."""
    return median_views_decide(gather(w, safe_idx), valid, self_vals, stride)


def fma_f32(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 operands (``b`` may be a Python float that
    is a float32 value), rounded once to float32, as a fused multiply-add
    rounds it.  The product is exact in float64; the
    sum is rounded to float64 *to odd* (a rounded result with an even last
    bit moves one ulp toward the error that TwoSum recovers), and rounding
    that to float32 is then correctly rounded, since float64 carries more
    than float32's 24 + 2 bits.  Differentiable as ``a * b + c``: the
    one-ulp step to odd is added as a constant (``nextafter`` has no
    derivative on every torch)."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else float(b))
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    sd = s.detach()
    even = (sd.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    # s + (nextafter(s) - s) is nextafter(s) exactly (a one-ulp difference)
    s = torch.where((err != 0) & even & torch.isfinite(sd),
                    s + (torch.nextafter(sd, toward) - sd).detach(), s)
    return s.float()


def expand_scales(scale: torch.Tensor, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-coordinate ``(scale, zero)`` ``[n, d]`` from ``[n, S, 2]``."""
    s = scale[..., 0].repeat_interleave(SCALE_BLOCK, dim=-1)[..., :d]
    z = scale[..., 1].repeat_interleave(SCALE_BLOCK, dim=-1)[..., :d]
    return s, z


def dequant(q: torch.Tensor, scale: torch.Tensor, keep_nan: bool = False) -> torch.Tensor:
    """Decode int8 codes ``q [n, d]`` with one ``(scale, zero)`` pair per
    `SCALE_BLOCK` coordinates (``scale [n, S, 2]``): ``q * scale + zero``,
    rounded once; NaN (an inf scale times a zero code, or a NaN scale)
    becomes +inf unless ``keep_nan``."""
    s, z = expand_scales(scale, q.shape[-1])
    out = fma_f32(q.float(), s, z)
    return out if keep_nan else sanitize(out)


def dequant_carry(q: torch.Tensor, scale: torch.Tensor, est: torch.Tensor, target: torch.Tensor,
                  zero_folded: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The codec's decode with its error-feedback carry: what receivers see
    ``x_hat = est + decoded`` and the residual ``target - decoded``.

    A zero term of exactly 0 (every codeword the codec writes) gives
    ``x_hat = fma(q, s, est)`` and ``resid = fma(-q, s, target)``, each
    rounded once: the reference's program, where XLA folds the constant
    zero away and contracts the multiply into the add.  Any other zero is
    decoded first, ``dec = fma(q, s, zero)``, and then added and
    subtracted, as the reference computes it when the zero is a run-time
    value.  ``zero_folded=False`` decodes first everywhere: the reference's
    program when a wire attack rewrote the scale field (``scale_abuse``),
    whose zero is then a run-time value on every row
    (``tests/test_torch_wire.py``).  No NaN guard, as in the reference's
    decode."""
    qf = q.float()
    s, z = expand_scales(scale, q.shape[-1])
    dec = fma_f32(qf, s, z)
    zero = (z == 0) & zero_folded
    x_hat = torch.where(zero, fma_f32(qf, s, est), est + dec)
    resid = torch.where(zero, fma_f32(-qf, s, target), target - dec)
    return x_hat, resid


def dequant_trimmed_mean_dense(q: torch.Tensor, scale: torch.Tensor, adj: torch.Tensor,
                               self_vals: torch.Tensor, b: int) -> torch.Tensor:
    """BRIDGE-T over int8 codewords (``q [M, d]``, ``scale [M, S, 2]``) at
    every node under ``adj [M, M]``, against its uncompressed
    ``self_vals``: `dequant`, then `trimmed_mean_dense`."""
    return trimmed_mean_dense(dequant(q, scale), adj, self_vals, b)


def dequant_median_dense(q: torch.Tensor, scale: torch.Tensor, adj: torch.Tensor,
                         self_vals: torch.Tensor) -> torch.Tensor:
    """BRIDGE-M over int8 codewords: `dequant`, then `median_dense` (the
    node's own uncompressed value joins the decoded rows)."""
    return median_dense(dequant(q, scale), adj, self_vals)


def gather_dequant_trimmed_mean(q: torch.Tensor, scale: torch.Tensor, safe_idx: torch.Tensor,
                                valid: torch.Tensor, self_vals: torch.Tensor,
                                b: int) -> torch.Tensor:
    """BRIDGE-T over int8 codewords on the sparse layout: `dequant`, then
    `gather_trimmed_mean`."""
    return gather_trimmed_mean(dequant(q, scale), safe_idx, valid, self_vals, b)


def gather_dequant_median(q: torch.Tensor, scale: torch.Tensor, safe_idx: torch.Tensor,
                          valid: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """BRIDGE-M over int8 codewords on the sparse layout: `dequant`, then
    `gather_median`."""
    return gather_median(dequant(q, scale), safe_idx, valid, self_vals)
