"""Omniscient adaptive attacks — port of `repro.adversary.adaptive`, over
stacked cells (see `repro_torch.adversary.protocols`).

* ``alie_online`` — ALIE at ``mu - z sigma`` with the tracked variance
  keeping a minimum band open, ``z`` the classic quantile bound floored at
  1.5, the lie extrapolated along the tracked consensus velocity by the
  channel's expected latency.
* ``ipm`` — inner-product manipulation in iterate space: the tracked
  consensus motion reversed, clipped to the per-coordinate band
  ``clip_z sigma``.
* ``dissensus`` — band-limited pushes of alternating sign along the tracked
  principal honest deviation axis; its message form pushes each receiver
  along its own side of the axis.
* ``inner_max`` — K steps (at most `K_MAX`) of projected sign-gradient
  ascent through the cell's own screen, warm-started from the previous
  tick's optimum, keeping the best iterate.  The screen is the cell's
  banked screen, so on the card the ascent runs the screening kernels
  forward and their plain backward (`repro_torch.kernels.autograd`).

Theta slot 0 selects the registered default.  ``theta`` arrives as the
cells' host float32 ``[E, THETA_DIM]``; the number of ascent steps is read
from it on the host, and a cell with fewer steps than another keeps its
iterate through the extra ones (the reference's per-cell loop bound).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.adversary.protocols import (_EMA, _EMA_C, Adversary, ema, observe, register,
                                             theta_on)
from repro_torch.kernels import ref


def _pick(value: torch.Tensor, default) -> torch.Tensor:
    """Theta slot semantics: 0 selects the registered default."""
    return torch.where(value > 0, value, default)


def _col(theta: np.ndarray, slot: int, device) -> torch.Tensor:
    """Slot ``slot`` of every cell's theta as an ``[E, 1]`` float32 column
    on ``device``."""
    return theta_on(theta, device)[:, slot:slot + 1]


def _substitute(w: torch.Tensor, byz_mask: torch.Tensor, crafted: torch.Tensor) -> torch.Tensor:
    """The Byzantine rows of ``w [E, M, d]`` replaced by ``crafted``
    (``[E, 1, d]`` or ``[E, M, d]``)."""
    return torch.where(byz_mask[..., None], crafted, w)


def _tracked_velocity(state, vel):
    """The EMA of the consensus velocity (the raw one on a cell's first two
    observations), stored as the state's direction."""
    vel_ema = torch.where((state.count > 1)[..., None], ema(state.dir, vel), vel)
    return state._replace(dir=vel_ema), vel_ema


# ---------------------------------------------------------------------------
# Online-sigma ALIE
# ---------------------------------------------------------------------------


def _auto_z(m: int, byz_mask: torch.Tensor) -> torch.Tensor:
    """The classic ALIE bound ``Phi^-1((n - s) / n)``, ``n`` honest nodes
    and ``s = floor(M / 2) + 1 - b`` supporters, per cell ``[E, 1]``."""
    b = byz_mask.sum(dim=-1, keepdim=True).to(torch.float32)
    n = torch.clamp(m - b, min=1.0)
    s = float(np.floor(m / 2.0)) + 1.0 - b
    q = torch.clamp((n - s) / n, 0.05, 0.95)
    return torch.special.ndtri(q.double()).to(torch.float32)


def _alie_online_fn(ctx, state, theta, w, byz_mask, key, t):
    state, mu, sigma, vel = observe(state, w, byz_mask)
    state, vel_ema = _tracked_velocity(state, vel)
    z = _pick(_col(theta, 0, w.device),
              torch.clamp(_auto_z(w.shape[-2], byz_mask), min=1.5))
    extrap = _pick(_col(theta, 1, w.device), 1.0)
    sigma_eff = torch.maximum(sigma, 0.5 * torch.sqrt(state.var + 1e-12))
    # XLA fuses both multiplies into the adds (one rounding each)
    crafted = ref.fma_f32(-z, sigma_eff, ref.fma_f32(extrap * ctx.latency, vel_ema, mu))
    return _substitute(w, byz_mask, crafted[..., None, :]), state


register(Adversary(
    "alie_online", _alie_online_fn, stateful=True,
    # theta: [z (0 = max(quantile bound, 1.5)), velocity-extrapolation gain]
    default_theta=(0.0, 1.0, 0.0, 0.0),
    theta_bounds=((0.05, 3.0), (0.01, 2.0), (0.0, 0.0), (0.0, 0.0)),
))


# ---------------------------------------------------------------------------
# Inner-product manipulation (iterate space)
# ---------------------------------------------------------------------------


def _ipm_fn(ctx, state, theta, w, byz_mask, key, t):
    state, mu, sigma, vel = observe(state, w, byz_mask)
    state, vel_ema = _tracked_velocity(state, vel)
    eps = _pick(_col(theta, 0, w.device), 6.0)
    clip_z = _pick(_col(theta, 1, w.device), 1.5)
    pert = -eps * (1.0 + ctx.latency) * vel_ema
    band = clip_z * sigma
    crafted = mu + torch.clamp(pert, -band, band)
    return _substitute(w, byz_mask, crafted[..., None, :]), state


register(Adversary(
    "ipm", _ipm_fn, stateful=True,
    # theta: [eps (motion-reversal gain), clip_z (band half-width in sigmas)]
    default_theta=(6.0, 1.5, 0.0, 0.0),
    theta_bounds=((0.5, 20.0), (0.5, 3.0), (0.0, 0.0), (0.0, 0.0)),
))


# ---------------------------------------------------------------------------
# Time-coupled dissensus
# ---------------------------------------------------------------------------


def _dissensus_core(state, theta, w, byz_mask):
    """``(state', mu, pert)``: the band-limited perturbation along the
    tracked principal honest deviation axis, sign-aligned across ticks."""
    state, mu, sigma, _ = observe(state, w, byz_mask)
    honest = ~byz_mask
    dev = torch.where(honest[..., None], w - mu[..., None, :], 0.0)
    j_star = torch.argmax(torch.sum(dev * dev, dim=-1), dim=-1)  # [E]
    u_inst = dev.gather(-2, j_star[:, None, None].expand(-1, 1, dev.shape[-1]))[:, 0]
    align = torch.where(torch.sum(u_inst * state.dir, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    u = torch.where((state.count > 1)[..., None],
                    ref.fma_f32(state.dir, _EMA, (_EMA_C * align) * u_inst), u_inst)
    state = state._replace(dir=u)
    z = _pick(_col(theta, 0, w.device), 1.5)
    pert = z * sigma * torch.tanh(u / (sigma + 1e-6))
    return state, mu, pert


def _dissensus_fn(ctx, state, theta, w, byz_mask, key, t):
    state, mu, pert = _dissensus_core(state, theta, w, byz_mask)
    # alternating signs across the Byzantine ranks
    rank = torch.cumsum(byz_mask.to(torch.int32), dim=-1) - 1
    sign = torch.where(byz_mask, 1.0 - 2.0 * (rank % 2).to(torch.float32), 0.0)
    crafted = ref.fma_f32(sign[..., None], pert[..., None, :], mu[..., None, :])
    return _substitute(w, byz_mask, crafted), state


def _dissensus_receiver_lies(ctx, state, theta, w, byz_mask):
    """``(state', crafted [E, M, d])``: each receiver pushed outward along
    its own side of the tracked axis."""
    state, mu, pert = _dissensus_core(state, theta, w, byz_mask)
    proj = torch.sum((w - mu[..., None, :]) * state.dir[..., None, :], dim=-1)
    side = torch.where(proj >= 0, 1.0, -1.0)
    return state, ref.fma_f32(side[..., None], pert[..., None, :], mu[..., None, :])


def _dissensus_message_fn(ctx, state, theta, w, byz_mask, adjacency, key, t):
    state, crafted = _dissensus_receiver_lies(ctx, state, theta, w, byz_mask)
    e, m, d = w.shape
    base = w[:, None].expand(e, m, m, d)
    lie = crafted[:, :, None].expand(e, m, m, d)
    if ctx.deliver_mask is not None:
        lie = torch.where(ctx.deliver_mask, lie, base)
    # no single broadcast value: Byzantine nodes screen with their iterate
    return torch.where(byz_mask[:, None, :, None], lie, base), w, state


def _dissensus_sparse_message_fn(ctx, state, theta, w, byz_mask, nbr, live, key, t):
    state, crafted = _dissensus_receiver_lies(ctx, state, theta, w, byz_mask)
    base = nbr.gather_rows(w, lead=1)  # [E, M, K, d]
    lie = crafted[:, :, None].expand_as(base)
    if ctx.deliver_mask is not None:
        lie = torch.where(ctx.deliver_mask, lie, base)
    senders = nbr.gather_senders(byz_mask, fill=False)
    return torch.where(senders[..., None], lie, base), w, state


register(Adversary(
    "dissensus", _dissensus_fn, stateful=True, message_fn=_dissensus_message_fn,
    sparse_message_fn=_dissensus_sparse_message_fn,
    # theta: [z (band half-width in sigmas)]
    default_theta=(1.5, 0.0, 0.0, 0.0),
    theta_bounds=((0.5, 3.0), (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
))


# ---------------------------------------------------------------------------
# Inner maximization through the screening step
# ---------------------------------------------------------------------------

K_MAX = 8  # bound on the ascent steps


class _Crafted(torch.autograd.Function):
    """``mu + delta * sigma`` as XLA compiles it, one rounding
    (`ref.fma_f32`), differentiable in ``delta`` (``sigma`` and ``mu`` are
    the tick's observations): the FMA emulation's rounding step has no
    derivative of its own."""

    @staticmethod
    def forward(ctx, delta, sigma, mu):
        ctx.save_for_backward(sigma)
        return ref.fma_f32(delta, sigma, mu)

    @staticmethod
    def backward(ctx, g):
        (sigma,) = ctx.saved_tensors
        return g * sigma, None, None


def ascent_steps(theta: np.ndarray) -> np.ndarray:
    """Each cell's number of ascent steps, ``clip(round(theta[2] or 6), 1,
    K_MAX)``, on the host (``[E]`` int)."""
    th = np.asarray(theta, np.float32).reshape(-1, 4)[:, 2]
    k = np.where(th > 0, th, np.float32(6.0))
    return np.clip(np.round(k).astype(np.int64), 1, K_MAX)


def _inner_max_fn(ctx, state, theta, w, byz_mask, key, t):
    state, mu, sigma, vel = observe(state, w, byz_mask)
    dev = w.device
    radius = _pick(_col(theta, 0, dev), 3.0)
    lr = _pick(_col(theta, 1, dev), 0.75)
    steps = ascent_steps(theta)
    if ctx.screen is None:  # no screening oracle on this path: the static fallback
        return _substitute(w, byz_mask, ref.fma_f32(-radius, sigma, mu)[..., None, :]), state

    honest = ~byz_mask
    cnt = torch.clamp(honest.sum(dim=-1), min=1).to(torch.float32)[..., None]

    def post_screen_mean(wb):
        y = ctx.screen(wb)
        return torch.sum(torch.where(honest[..., None], y, 0.0), dim=-2) / cnt

    with torch.no_grad():
        y0_mean = post_screen_mean(w)  # what consensus would do unattacked
    vnorm = torch.sqrt(torch.sum(vel * vel, dim=-1, keepdim=True)) + 1e-12
    drift = vel / vnorm
    beta = _pick(_col(theta, 3, dev), 1.0)
    seen = state.count > 1

    def objective(delta):
        crafted = _Crafted.apply(delta, sigma, mu)
        disp = post_screen_mean(_substitute(w, byz_mask, crafted[..., None, :])) - y0_mean
        along = torch.sum(disp * drift, dim=-1)
        return torch.sum(disp * disp, dim=-1) + torch.where(
            seen, beta[:, 0] * along * torch.abs(along), 0.0)

    def value_and_sign(delta):
        """The objective at ``delta`` and the sign of its gradient there
        (one screen forward, its backward)."""
        leaf = delta.detach().requires_grad_(True)
        with torch.enable_grad():
            o = objective(leaf)
            (g,) = torch.autograd.grad(o.sum(), leaf)
        return o.detach(), torch.sign(g)

    alie_pt = (-torch.clamp(radius, max=1.5)).expand_as(mu).contiguous()
    warm = torch.where(seen[..., None], torch.clamp(state.dir, -radius, radius), alie_pt)
    with torch.no_grad():
        o_alie = objective(alie_pt)
    o_warm, g = value_and_sign(warm)
    best = torch.where((o_alie > o_warm)[..., None], alie_pt, warm)
    best_obj = torch.maximum(o_warm, o_alie)
    delta = warm
    k_max = int(steps.max())
    active = torch.as_tensor(steps, device=dev)
    for i in range(k_max):
        step = torch.clamp(delta + lr * g, -radius, radius)
        if i + 1 < k_max:
            o, g = value_and_sign(step)
        else:
            with torch.no_grad():
                o = objective(step)
        on = i < active  # cells still ascending
        delta = torch.where(on[..., None], step, delta)
        better = on & (o > best_obj)
        best = torch.where(better[..., None], delta, best)
        best_obj = torch.where(on, torch.maximum(o, best_obj), best_obj)
    state = state._replace(dir=best)
    return _substitute(w, byz_mask, ref.fma_f32(best, sigma, mu)[..., None, :]), state


register(Adversary(
    "inner_max", _inner_max_fn, stateful=True,
    # theta: [radius (sigmas), lr (sigmas/step), K (ascent steps, <= K_MAX),
    #         beta (drift-compounding weight)]
    default_theta=(3.0, 0.75, 6.0, 1.0),
    theta_bounds=((1.0, 4.0), (0.1, 2.0), (1.0, float(K_MAX)), (0.01, 4.0)),
))
