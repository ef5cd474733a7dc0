"""The screening kernels under autograd: a `torch.autograd.Function` whose
forward is the kernel (its plain version on the CPU, through
`repro_torch.kernels.ops`) and whose backward is plain PyTorch, for every
kernel-backed coordinate-wise screen — the dense trimmed mean and median
(rows 1-2, the wide path above 128 rows included), their gathered forms
(row 3) and their views forms.  The adaptive adversary ``inner_max``
ascends through a cell's screen (`repro_torch.adversary.adaptive`); this is
what lets it run on the card's kernels.

The backward is the reference's gradient (``jax.grad`` through
`repro.core.screening`): per node and coordinate, the values are ranked
(NaN read as +inf, masked rows last, a stable sort) and the cotangent goes
to the kept ranks.

* Trimmed mean: ``1 / (count - 2 b_eff + 1)`` to each neighbor ranked in
  ``[b_eff, count - b_eff)`` and to the node's own value (``b_eff`` the
  clamped trim, `ref.effective_trim`); with ``recip`` the multiply by the
  float32 reciprocal the forward used.
* Median: over the neighbors and the node itself, ``1/2`` to each of the
  ranks ``(count - 1) // 2`` and ``count // 2`` (1 when they coincide).

Masked and NaN entries get no gradient.  Tied values may split a rank's
cotangent differently from the reference's Batcher network (whose min/max
gradient halves a tie), but every tied group receives the same total, and
the gradient of a row shared by the group (``inner_max``'s crafted row) is
that total.  The backward ranks ``d`` in chunks, so its sort never holds
more than `CHUNK_ELEMS` values.

On the card the views form's backward is a hand-written kernel,
``views_screen_grad_*`` (``csrc/views_screen_grad.cu``, any number of
slots): the same ranks by W^2 compares a column, equal to
`plain_backward` bit for bit.
It is where the plain backward cost most (the sparse runtime's oracle at
M = 512, K = 16: a sort of every node's views, six a tick); the dense and
gathered forms keep the plain backward.  ``views_grad_trimmed_mean`` and
``views_grad_median`` count its launches.

`screen` is the entry: with no input that needs a gradient it is the plain
kernel call, so the trainers' forward path is unchanged.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ops, ref

# The most values the backward ranks at once (a chunk of coordinates).
CHUNK_ELEMS = 1 << 24


class ScreenSpec(NamedTuple):
    """One screen call: ``forward(x, self_vals) -> y`` (a kernel entry of
    `ops`), the rule (``trimmed_mean`` or ``median``), how the per-node
    values derive from ``x`` (``dense``, ``gather``, ``views``), the mask
    ``[.., M, n]``, the bound and the divisor form."""

    forward: Callable
    rule: str
    form: str
    mask: torch.Tensor
    b: object = 0
    recip: bool = False
    safe_idx: torch.Tensor | None = None


class _Screen(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec: ScreenSpec, x: torch.Tensor, self_vals: torch.Tensor):
        ctx.spec = spec
        ctx.save_for_backward(x, self_vals)
        return spec.forward(x, self_vals)

    @staticmethod
    def backward(ctx, gy):
        x, self_vals = ctx.saved_tensors
        gx, gs = _backward(ctx.spec, x, self_vals, gy)
        return None, gx, gs


def screen(spec: ScreenSpec, x: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """``spec.forward(x, self_vals)``, differentiable in ``x`` and
    ``self_vals`` when either needs a gradient."""
    if torch.is_grad_enabled() and (x.requires_grad or self_vals.requires_grad):
        return _Screen.apply(spec, x, self_vals)
    return spec.forward(x, self_vals)


def trimmed_mean(w, adj, self_vals, b, recip: bool = False):
    """`ops.trimmed_mean` (rows 1, wide path) under autograd."""
    return screen(ScreenSpec(lambda x, s: ops.trimmed_mean(x, adj, s, b, recip),
                             "trimmed_mean", "dense", adj, b, recip), w, self_vals)


def median(w, adj, self_vals):
    """`ops.median` (row 2, wide path) under autograd."""
    return screen(ScreenSpec(lambda x, s: ops.median(x, adj, s), "median", "dense", adj),
                  w, self_vals)


def gather_trimmed_mean(w, safe_idx, valid, self_vals, b):
    """`ops.gather_trimmed_mean` (row 3) under autograd."""
    return screen(ScreenSpec(lambda x, s: ops.gather_trimmed_mean(x, safe_idx, valid, s, b),
                             "trimmed_mean", "gather", valid, b, safe_idx=safe_idx), w, self_vals)


def gather_median(w, safe_idx, valid, self_vals):
    """`ops.gather_median` (row 3) under autograd."""
    return screen(ScreenSpec(lambda x, s: ops.gather_median(x, safe_idx, valid, s),
                             "median", "gather", valid, safe_idx=safe_idx), w, self_vals)


def views_trimmed_mean(views, mask, self_vals, b):
    """`ops.views_trimmed_mean` under autograd."""
    return screen(ScreenSpec(lambda x, s: ops.views_trimmed_mean(x, mask, s, b),
                             "trimmed_mean", "views", mask, b), views, self_vals)


def views_median(views, mask, self_vals):
    """`ops.views_median` under autograd."""
    return screen(ScreenSpec(lambda x, s: ops.views_median(x, mask, s), "median", "views", mask),
                  views, self_vals)


def _values(spec: ScreenSpec, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Coordinates ``[lo, hi)`` of each node's values ``[E, M, n, c]``."""
    xc = x[..., lo:hi]
    if spec.form == "dense":
        e, m, c = xc.shape
        return xc[:, None].expand(e, m, m, c)
    if spec.form == "gather":
        return ref.gather(xc, spec.safe_idx)
    return xc


def _rank_weights(spec: ScreenSpec, values: torch.Tensor, self_c: torch.Tensor):
    """Each value's and each node's own value's weight in the output:
    ``([E, M, n, c], [E, M, c] or a float tensor)``."""
    mask = spec.mask.bool()
    n = values.shape[-2]
    rank = torch.arange(n + (spec.rule == "median"), device=values.device)[:, None]
    if spec.rule == "trimmed_mean":
        count = mask.sum(dim=-1)
        b_eff = ref.effective_trim(spec.b, count)
        den = (count - 2 * b_eff + 1).to(torch.float32)[..., None, None]
        w_rank = (1.0 / den) if spec.recip else None
        keep = (rank >= b_eff[..., None, None]) & (rank < (count - b_eff)[..., None, None])
        masked = torch.where(mask[..., None], ref.sanitize(values), torch.inf)
        order = torch.sort(masked, dim=-2, stable=True).indices
        kept = torch.zeros(order.shape, dtype=torch.bool, device=values.device)
        kept.scatter_(-2, order, keep.expand(order.shape))
        kept &= mask[..., None] & ~torch.isnan(values)
        return kept, (w_rank, den)
    full = torch.cat([mask, torch.ones_like(mask[..., :1])], dim=-1)
    stacked = torch.cat([values, self_c[..., None, :]], dim=-2)
    count = full.sum(dim=-1)
    lo = ((count - 1) // 2)[..., None, None]
    hi = (count // 2)[..., None, None]
    pick = 0.5 * ((rank == lo).to(torch.float32) + (rank == hi).to(torch.float32))
    masked = torch.where(full[..., None], ref.sanitize(stacked), torch.inf)
    order = torch.sort(masked, dim=-2, stable=True).indices
    wts = torch.zeros(order.shape, dtype=torch.float32, device=values.device)
    wts.scatter_(-2, order, pick.expand(order.shape))
    wts = torch.where(full[..., None] & ~torch.isnan(stacked), wts, 0.0)
    return wts, None


def views_grad_trimmed_mean(views: torch.Tensor, mask: torch.Tensor, gy: torch.Tensor,
                            b) -> tuple[torch.Tensor, torch.Tensor]:
    """The views trimmed mean's backward on the card: ``(grad views [E, M,
    W, d], grad self_vals [E, M, d])`` for the cotangent ``gy [E, M, d]``
    (``views`` at any strides with unit coordinate stride, ``mask`` ``[M,
    W]`` or ``[E, M, W]``, ``b`` an int or an int32 ``[E]`` tensor)."""
    g_views, g_self, args = _grad_operands(views, mask, gy)
    b0, b_ptr = (0, b.data_ptr()) if isinstance(b, torch.Tensor) else (int(b), None)
    err = build.load().views_screen_grad_trimmed_mean(*args[:6], gy.data_ptr(), g_views.data_ptr(),
                                                      g_self.data_ptr(), *args[6:], b0, b_ptr,
                                                      build.stream_of(gy))
    build.check_launch(err, "views_screen_grad_trimmed_mean")
    views_grad_trimmed_mean.launches += 1
    return g_views, g_self


def views_grad_median(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                      gy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The views median's backward on the card (`views_grad_trimmed_mean`'s
    operands and the node's own values ``self_vals [E, M, d]``)."""
    g_views, g_self, args = _grad_operands(views, mask, gy)
    err = build.load().views_screen_grad_median(*args[:6], self_vals.data_ptr(), gy.data_ptr(),
                                                g_views.data_ptr(), g_self.data_ptr(), *args[6:],
                                                build.stream_of(gy))
    build.check_launch(err, "views_screen_grad_median")
    views_grad_median.launches += 1
    return g_views, g_self


views_grad_trimmed_mean.launches = 0
views_grad_median.launches = 0


def _grad_operands(views, mask, gy):
    """The outputs and the leading C arguments of a views backward launch."""
    e, m, w, d = views.shape
    if views.stride(-1) != 1:
        views = views.contiguous()
    mask = mask.contiguous()
    s_mask = m * w if mask.ndim == 3 else 0
    g_views = torch.empty((e, m, w, d), dtype=torch.float32, device=views.device)
    g_self = torch.empty((e, m, d), dtype=torch.float32, device=views.device)
    args = (views.data_ptr(), views.stride(0) if e > 1 else 0, views.stride(1), views.stride(2),
            mask.data_ptr(), s_mask, e, m, w, d)
    return g_views, g_self, args


def _backward(spec: ScreenSpec, x: torch.Tensor, self_vals: torch.Tensor, gy: torch.Tensor):
    """``(grad x, grad self_vals)`` of ``y = spec.forward(x, self_vals)``:
    the views form's kernel on the card, else `plain_backward`."""
    if spec.form != "views" or not x.is_cuda:
        return plain_backward(spec, x, self_vals, gy)
    batched = self_vals.ndim == 2
    if batched:  # one experiment without its axis
        x, self_vals, gy = x[None], self_vals[None], gy[None]
    gy = gy.contiguous()
    gx, gs = (views_grad_trimmed_mean(x, spec.mask, gy, spec.b) if spec.rule == "trimmed_mean"
              else views_grad_median(x, spec.mask, self_vals.contiguous(), gy))
    return (gx[0], gs[0]) if batched else (gx, gs)


def plain_backward(spec: ScreenSpec, x: torch.Tensor, self_vals: torch.Tensor,
                   gy: torch.Tensor):
    """`_backward` in plain PyTorch on any device (a stable sort of each
    node's values): the dense and gathered forms' backward, and the views
    backward kernels' plain version."""
    batched = self_vals.ndim == 2
    if batched:  # one experiment without its axis
        x, self_vals, gy = x[None], self_vals[None], gy[None]
    e, m, d = self_vals.shape
    n = spec.mask.shape[-1]
    gx = torch.zeros_like(x)
    gs = torch.zeros_like(self_vals)
    step = max(1, CHUNK_ELEMS // max(e * m * (n + 1), 1))
    for lo in range(0, d, step):
        hi = min(d, lo + step)
        values = _values(spec, x, lo, hi)
        g = gy[..., lo:hi]
        if spec.rule == "trimmed_mean":
            kept, (w_rank, den) = _rank_weights(spec, values, self_vals[..., lo:hi])
            scale = g * w_rank[..., 0] if spec.recip else g / den[..., 0]
            g_vals = torch.where(kept, scale[..., None, :], 0.0)
            gs[..., lo:hi] = scale
        else:
            wts, _ = _rank_weights(spec, values, self_vals[..., lo:hi])
            g_all = wts * g[..., None, :]
            g_vals = g_all[..., :-1, :]
            gs[..., lo:hi] = g_all[..., -1, :]
        if spec.form == "dense":
            gx[..., lo:hi] = g_vals.sum(dim=1)
        elif spec.form == "gather":
            flat = g_vals.reshape(e, -1, hi - lo)
            gx[..., lo:hi] = torch.zeros((e, m, hi - lo), dtype=gx.dtype, device=gx.device) \
                .index_add_(1, spec.safe_idx.reshape(-1).long(), flat)
        else:
            gx[..., lo:hi] = g_vals
    if batched:
        gx, gs = gx[0], gs[0]
    return gx, gs
