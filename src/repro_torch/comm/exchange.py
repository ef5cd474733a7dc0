"""The compressed exchange with delta tracking and error feedback — port
of `repro.comm.exchange` for one codec on the broadcast path (the
reference's ``encode_bank`` / ``decode_bank`` with a bank of one, per
sender: ``[M, d]``; the per-link carries wait for the network runtime).

A lossy codec does not compress the raw iterate.  The carry (`CommState`)
holds ``est``, the public copy every receiver keeps of a sender's iterate,
and ``resid``, the error feedback on what was sent.  A sender transmits
``compress((x - est) + resid)``; receivers see ``x_hat = est + decoded``,
the public copy moves to ``x_hat`` and the residual becomes
``target - decoded``.  For the dense modes (``int8``, ``int4``) the decode
and the carry update are one kernel
(`repro_torch.kernels.dequant.dequant_carry`), which rounds each output
once, as the reference's program does.  A sparse codec (``topk``,
``randk``) decodes its kept values (the ``dequant`` kernel when quantized)
and scatters them; then ``x_hat = est + decoded`` and the residual is
kept *in support* only, ``where(support, target - decoded, 0)``: the
coordinates it did not send stay in the next delta, as ``est`` did not move
there.  The scatter sits between the decode's multiply and these adds, so
each rounds on its own, as in the reference's program
(``tools/xla_divisor_forms.py``).  randk's support is re-derived from the
key, never read from ``msg.idx``.  A lossless codec passes everything
through structurally untouched and carries no state.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.comm.codec import Codec, WireMsg, scatter_last
from repro_torch.kernels import ops


class CommState(NamedTuple):
    """Wire-codec carry of one message tensor."""

    est: torch.Tensor  # receivers' running decoded estimate (public copy)
    resid: torch.Tensor  # error-feedback accumulator on the transmitted delta


def init_residual(shape: tuple[int, ...], codec: Codec, *,
                  device: str | torch.device) -> CommState | None:
    """Zero estimate and residual for a message tensor of ``shape``, or
    ``None`` for a lossless codec."""
    if codec.lossless:
        return None
    return CommState(torch.zeros(shape, device=device), torch.zeros(shape, device=device))


def _require_carry(codec: Codec, state: CommState | None) -> None:
    """A lossy codec without its carry would send the raw iterate and drop
    the error feedback: another algorithm, so it raises."""
    if state is None:
        raise ValueError(f"codec {codec.name!r} is lossy and needs its CommState carry "
                         f"(BridgeTrainer.init_comm, or convert.state_from_jax(comm=...))")


def encode(codec: Codec, key: np.ndarray, x: torch.Tensor,
           state: CommState | None) -> tuple[WireMsg, torch.Tensor]:
    """Encode ``x [..., d]``: a lossy codec transmits
    ``(x - est) + resid``.  Returns ``(msg, target)``, ``target`` being what
    the codec tried to send."""
    if codec.lossless:
        return codec.encode(key, x), x
    _require_carry(codec, state)
    target = (x - state.est) + state.resid
    return codec.encode(key, target), target


def decode(codec: Codec, msg: WireMsg, target: torch.Tensor, state: CommState | None,
           key: np.ndarray | None = None,
           zero_folded: bool = True) -> tuple[torch.Tensor, CommState | None]:
    """Decode the (possibly wire-attacked) ``msg`` and advance the carry:
    returns ``(x_hat, state')``.  ``key`` is the encoder's comm key, from
    which randk re-derives its indices; ``zero_folded=False`` when a wire
    attack rewrote the scale field (`ref.dequant_carry`)."""
    d = target.shape[-1]
    if codec.lossless:
        return codec.decode(msg, d, key), state
    _require_carry(codec, state)
    if codec.mode == "dense":
        x_hat, resid = ops.dequant_carry(*codec.codes(msg, d), state.est, target, zero_folded)
        return x_hat, CommState(est=x_hat, resid=resid)
    dec = codec.decode(msg, d, key)
    x_hat = state.est + dec
    sidx = codec.support(msg, d, key)
    support = scatter_last(sidx, torch.ones(sidx.shape, dtype=torch.bool, device=sidx.device), d)
    resid = torch.where(support, target - dec, 0.0)
    return x_hat, CommState(est=x_hat, resid=resid)
