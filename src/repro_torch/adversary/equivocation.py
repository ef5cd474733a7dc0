"""Protocol-level adversaries — port of `repro.adversary.equivocation`,
over stacked cells.

* ``equivocate`` — a sender tells different receivers different lies:
  receiver j gets ``mu + sgn(j, i) z sigma`` from Byzantine sender i, the
  sign alternating with the parity of ``j + i``.  On the broadcast path a
  sender has one payload, and the lie is the minus side's.
* ``slander`` — honest values, forged gossip: a Byzantine node reports
  every digest shifted by ``theta[0]`` (default 1e3).  Only the trust
  layer's echo protocol reads digests; on every other path the adversary
  is the identity.
"""
from __future__ import annotations

import torch

from repro_torch.adversary.adaptive import _col, _pick, _substitute
from repro_torch.adversary.protocols import Adversary, observe, register
from repro_torch.kernels import ref


def _equiv_core(state, theta, w, byz_mask):
    """``(state', mu, sigma, z)``: the tracked honest center, the spread
    and the half-width in sigmas the lies sit at."""
    state, mu, sigma, _ = observe(state, w, byz_mask)
    return state, mu, sigma, _pick(_col(theta, 0, w.device), 1.5)


def sign_grid(m: int, device) -> torch.Tensor:
    """``[receiver, sender]``: +1 or -1 by the parity of ``j + i``."""
    j = torch.arange(m, device=device)
    return 1.0 - 2.0 * ((j[:, None] + j[None, :]) % 2).to(torch.float32)


def _equivocate_fn(ctx, state, theta, w, byz_mask, key, t):
    state, mu, sigma, z = _equiv_core(state, theta, w, byz_mask)
    # XLA fuses the band's multiply into the subtract
    return _substitute(w, byz_mask, ref.fma_f32(-z, sigma, mu)[..., None, :]), state


def _lie(mu, sigma, z, sgn):
    """``mu + sgn (z sigma)`` over ``sgn [M, W]``: ``[E, M, W, d]``, the
    sign's multiply fused into the add as XLA compiles it."""
    return ref.fma_f32(sgn[None, :, :, None], (z * sigma)[:, None, None, :],
                       mu[:, None, None, :])


def _equivocate_message_fn(ctx, state, theta, w, byz_mask, adjacency, key, t):
    state, mu, sigma, z = _equiv_core(state, theta, w, byz_mask)
    e, m, d = w.shape
    base = w[:, None].expand(e, m, m, d)
    lie = _lie(mu, sigma, z, sign_grid(m, w.device))
    if ctx.deliver_mask is not None:
        lie = torch.where(ctx.deliver_mask, lie, base)
    return torch.where(byz_mask[:, None, :, None], lie, base), w, state


def _equivocate_sparse_message_fn(ctx, state, theta, w, byz_mask, nbr, live, key, t):
    state, mu, sigma, z = _equiv_core(state, theta, w, byz_mask)
    sgn = nbr.gather_edges(sign_grid(nbr.num_nodes, w.device))  # [M, K]
    base = nbr.gather_rows(w, lead=1)  # [E, M, K, d]
    lie = _lie(mu, sigma, z, sgn)
    if ctx.deliver_mask is not None:
        lie = torch.where(ctx.deliver_mask, lie, base)
    senders = nbr.gather_senders(byz_mask, fill=False)
    return torch.where(senders[..., None], lie, base), w, state


register(Adversary(
    "equivocate", _equivocate_fn, stateful=True, tier="equivocator",
    message_fn=_equivocate_message_fn,
    sparse_message_fn=_equivocate_sparse_message_fn,
    # theta: [z (band half-width in sigmas)]
    default_theta=(1.5, 0.0, 0.0, 0.0),
    theta_bounds=((0.5, 3.0), (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
))


def _slander_fn(ctx, state, theta, w, byz_mask, key, t):
    return w, state  # the values stay honest


def slander_accuse(theta, digests: torch.Tensor, byz_mask: torch.Tensor, key, t) -> torch.Tensor:
    """The digest rows Byzantine reporters gossip, every entry shifted by
    ``theta[0]`` (0: 1e3): ``digests [E, M, M, q]``, ``byz_mask [E, M]``
    over the reporters."""
    mag = _pick(_col(theta, 0, digests.device), 1e3)[:, :, None, None]
    return digests + torch.where(byz_mask[:, :, None, None], mag, 0.0)


register(Adversary(
    "slander", _slander_fn, stateful=False, tier="slanderer",
    accuse_fn=slander_accuse,
    # theta: [digest forgery magnitude]
    default_theta=(1e3, 0.0, 0.0, 0.0),
    theta_bounds=((1.0, 1e6), (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
))
