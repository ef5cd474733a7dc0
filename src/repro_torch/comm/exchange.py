"""The compressed exchange with delta tracking and error feedback — port
of `repro.comm.exchange` for one codec on the broadcast path (the
reference's ``encode_bank`` / ``decode_bank`` with a bank of one, per
sender: ``[M, d]``).

A lossy codec does not compress the raw iterate.  The carry (`CommState`)
holds ``est``, the public copy every receiver keeps of a sender's iterate,
and ``resid``, the error feedback on what was sent.  A sender transmits
``compress((x - est) + resid)``; receivers see ``x_hat = est + decoded``,
the public copy moves to ``x_hat`` and the residual becomes
``target - decoded``.  The decode and the carry update are one kernel
(`repro_torch.kernels.dequant.dequant_carry`), which rounds each output
once, as the reference's program does.  A lossless codec passes everything
through structurally untouched and carries no state.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.comm.codec import Codec, WireMsg
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


def decode(codec: Codec, msg: WireMsg, target: torch.Tensor,
           state: CommState | None) -> tuple[torch.Tensor, CommState | None]:
    """Decode ``msg`` and advance the carry: returns ``(x_hat, state')``."""
    if codec.lossless:
        return codec.decode(msg, target.shape[-1]), state
    _require_carry(codec, state)
    x_hat, resid = ops.dequant_carry(msg.payload, msg.scale, state.est, target)
    return x_hat, CommState(est=x_hat, resid=resid)
