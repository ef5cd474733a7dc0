"""The compressed exchange with delta tracking and error feedback — port
of `repro.comm.exchange`: the bank forms (`encode_bank`, `decode_bank`,
`wire_bits_bank`) over a leading axis of units, each unit with its own
codec from a static bank, and the one-codec `encode` / `decode` they call.

A unit is what one key encodes: a cell's ``[M, d]`` broadcast on the
synchronous path (the cells' host row keys ``[E, 2]``), or one link's
``[d]`` message on the runtime path (device row keys, one an edge and
cell).  A bank of one codec, or units that all chose one, is a single
`encode` / `decode` over every unit; a mixed bank runs each codec once over
the units that chose it, pads every codeword to the bank's largest
payload, index set and scale table (as the reference's ``lax.switch``
branches do, so a wire attack draws over the same shapes) and scatters
the results back.

A lossy codec does not compress the raw iterate.  The carry (`CommState`)
holds ``est``, the public copy every receiver keeps of a sender's iterate,
and ``resid``, the error feedback on what was sent.  A sender transmits
``compress((x - est) + resid)``; receivers see ``x_hat = est + decoded``,
the public copy moves to ``x_hat`` and the residual becomes
``target - decoded``.  For the dense modes (``int8``, ``int4``) the decode
and the carry update are one kernel
(`repro_torch.kernels.dequant.dequant_carry`), launched once over every
unit's rows, which rounds each output once, as the reference's program
does.  A sparse codec (``topk``,
``randk``) decodes its kept values (the ``dequant`` kernel when quantized)
and scatters them; then ``x_hat = est + decoded`` and the residual is
kept *in support* only, ``where(support, target - decoded, 0)``: the
coordinates it did not send stay in the next delta, as ``est`` did not move
there.  The scatter sits between the decode's multiply and these adds, so
each rounds on its own, as in the reference's program
(``tools/xla_divisor_forms.py``).  randk's support is re-derived from the
key, never read from ``msg.idx``.  A lossless codec passes everything
through structurally untouched: no carry when the whole bank is lossless,
and its units' carry unchanged in a mixed bank.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.comm.codec import Codec, WireMsg, scatter_last
from repro_torch.kernels import ops


class CommState(NamedTuple):
    """Wire-codec carry of one message tensor."""

    est: torch.Tensor  # receivers' running decoded estimate (public copy)
    resid: torch.Tensor  # error-feedback accumulator on the transmitted delta


def _bank(codecs) -> tuple[Codec, ...]:
    return (codecs,) if isinstance(codecs, Codec) else tuple(codecs)


def bank_is_lossless(bank: Sequence[Codec]) -> bool:
    """Whether no codec of the bank needs the carry."""
    return all(c.lossless for c in _bank(bank))


def bank_sizes(bank: Sequence[Codec], d: int) -> tuple[int, int, int]:
    """(payload bytes P, index slots K, scale pairs S) every codeword of
    the bank is padded to."""
    bank = _bank(bank)
    p = max(c.payload_bytes(d) for c in bank)
    k = max((c.kept(d) for c in bank if c.mode != "dense"), default=0)
    s = max(c.nscales(d) for c in bank)
    return p, k, s


def max_wire_bits(bank: Sequence[Codec], d: int) -> int:
    """The largest message of the bank, which a mailbox ring is sized for."""
    return max(c.wire_bits(d) for c in _bank(bank))


def wire_bits_bank(bank: Sequence[Codec], codec_idx, d: int):
    """Bits on the wire per message of each unit's codec: an int when every
    unit's codec sends the same, else a tuple, one a unit."""
    bank = _bank(bank)
    bits = tuple(bank[i].wire_bits(d) for i in _indices(codec_idx, 1))
    return bits[0] if len(set(bits)) == 1 else bits


def wire_bits_blocks(bank: Sequence[Codec], codec_idx, sizes: Sequence[int]):
    """Bits on the wire of one message streamed as independent codewords of
    the block sizes ``sizes``: each block pays its own scales and index
    header, so each unit's codec is summed over the blocks."""
    bank = _bank(bank)
    bits = tuple(sum(bank[i].wire_bits(s) for s in sizes) for i in _indices(codec_idx, 1))
    return bits[0] if len(set(bits)) == 1 else bits


def init_residual(shape: tuple[int, ...], bank, *,
                  device: str | torch.device) -> CommState | None:
    """Zero estimate and residual for a message tensor of ``shape``, or
    ``None`` when every codec of ``bank`` (a sequence, or one `Codec`) is
    lossless."""
    if bank_is_lossless(bank):
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
        # one launch over every row of every unit
        rows = lambda a: a.reshape(-1, d).contiguous()
        x_hat, resid = ops.dequant_carry(*codec.codes(msg, d), rows(state.est), rows(target),
                                         zero_folded)
        x_hat, resid = x_hat.reshape(target.shape), resid.reshape(target.shape)
        return x_hat, CommState(est=x_hat, resid=resid)
    dec = codec.decode(msg, d, key)
    x_hat = state.est + dec
    sidx = codec.support(msg, d, key)
    support = scatter_last(sidx, torch.ones(sidx.shape, dtype=torch.bool, device=sidx.device), d)
    resid = torch.where(support, target - dec, 0.0)
    return x_hat, CommState(est=x_hat, resid=resid)


def _indices(codec_idx, units: int) -> np.ndarray:
    """Each unit's bank index (None: entry 0 for all)."""
    if codec_idx is None:
        return np.zeros((units,), np.int64)
    return np.asarray(codec_idx, np.int64).reshape(-1)


def _pad(x: torch.Tensor, size: int, dim: int = -1) -> torch.Tensor:
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - (dim % x.ndim) - 1) + [0, pad]
    return torch.nn.functional.pad(x, widths)


def _padded(msg: WireMsg, sizes: tuple[int, int, int]) -> WireMsg:
    p, k, s = sizes
    return WireMsg(_pad(msg.payload, p), _pad(msg.scale, s, dim=-2), _pad(msg.idx, k))


def _rows_of(key, sel_np: np.ndarray, sel: torch.Tensor):
    """The keys of the units ``sel``: host row keys or device row keys
    ``[U, 2]`` (a single key serves one unit)."""
    if isinstance(key, torch.Tensor):
        return key.index_select(0, sel)
    key = np.asarray(key)
    return key[sel_np] if key.ndim == 2 else key


def _state_rows(state: CommState | None, sel: torch.Tensor) -> CommState | None:
    return None if state is None else CommState(*(a.index_select(0, sel) for a in state))


def _split(bank, codec_idx, units: int):
    """The codecs the units use: ``[(codec, host units, device units or
    None)]``, None when every unit uses it."""
    idx = _indices(codec_idx, units)
    used = sorted(set(idx.tolist()))
    if len(used) == 1:
        return [(bank[used[0]], None)]
    return [(bank[c], np.nonzero(idx == c)[0]) for c in used]


def encode_bank(bank: Sequence[Codec], codec_idx, key, x: torch.Tensor,
                state: CommState | None) -> tuple[WireMsg, torch.Tensor]:
    """`encode` of each unit of ``x [U, ...]`` with its codec
    ``bank[codec_idx[u]]`` under its key; a mixed bank pads every codeword
    to `bank_sizes`.  Returns ``(msg, target)``."""
    bank = _bank(bank)
    d = x.shape[-1]
    sizes = bank_sizes(bank, d)
    parts = _split(bank, codec_idx, x.shape[0])
    if parts[0][1] is None:
        msg, target = encode(parts[0][0], key, x, state)
        return (msg if len(bank) == 1 else _padded(msg, sizes)), target
    out_msg = out_target = None
    for codec, cells in parts:
        sel = torch.as_tensor(cells, device=x.device)
        msg, target = encode(codec, _rows_of(key, cells, sel), x.index_select(0, sel),
                             _state_rows(state, sel) if not codec.lossless else None)
        msg = _padded(msg, sizes)
        if out_msg is None:
            out_msg = WireMsg(*(torch.zeros((x.shape[0], *f.shape[1:]), dtype=f.dtype,
                                            device=f.device) for f in msg))
            out_target = torch.empty_like(x)
        for out, f in zip(out_msg, msg, strict=True):
            out.index_copy_(0, sel, f)
        out_target.index_copy_(0, sel, target)
    return out_msg, out_target


def decode_bank(bank: Sequence[Codec], codec_idx, msg: WireMsg, target: torch.Tensor,
                state: CommState | None, key=None,
                zero_folded: bool = True) -> tuple[torch.Tensor, CommState | None]:
    """`decode` of each unit's (possibly wire-attacked) codeword with its
    codec and carry: ``(x_hat [U, ...], state')``.  A lossless codec's
    units keep their carry as it was; each lossy codec decodes all its
    units' rows at once (one ``dequant_carry`` launch for the dense
    modes)."""
    bank = _bank(bank)
    parts = _split(bank, codec_idx, target.shape[0])
    if parts[0][1] is None:
        codec = parts[0][0]
        if len(bank) > 1:
            msg = _slice(msg, codec, target.shape[-1])
        return decode(codec, msg, target, state, key, zero_folded)
    x_out = torch.empty_like(target)
    new = None if state is None else CommState(*(a.clone() for a in state))
    for codec, cells in parts:
        sel = torch.as_tensor(cells, device=target.device)
        part = WireMsg(*(f.index_select(0, sel) for f in _slice(msg, codec, target.shape[-1])))
        x_hat, st = decode(codec, part, target.index_select(0, sel),
                           _state_rows(state, sel), _rows_of(key, cells, sel)
                           if key is not None else None, zero_folded)
        x_out.index_copy_(0, sel, x_hat)
        if new is not None and not codec.lossless:
            for out, a in zip(new, st, strict=True):
                out.index_copy_(0, sel, a)
    return x_out, new


def _slice(msg: WireMsg, codec: Codec, d: int) -> WireMsg:
    """A padded codeword cut back to ``codec``'s own fields."""
    return WireMsg(msg.payload[..., : codec.payload_bytes(d)].contiguous(),
                   msg.scale[..., : codec.nscales(d), :].contiguous(),
                   msg.idx[..., : (0 if codec.mode == "dense" else codec.kept(d))].contiguous())
