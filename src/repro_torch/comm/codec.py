"""Wire codecs: what travels on an edge per tick — port of
`repro.comm.codec`.

A `Codec` turns the flattened iterate ``x [..., d]`` into a `WireMsg` and
back; ``wire_bits(d)`` is the exact bits on the wire per message.

* ``identity`` — an exact float32 bitcast (lossless: the trainer skips the
  wire for it unless a wire attack is on, so its path stays structurally
  untouched).
* ``int8`` / ``int4`` — symmetric stochastic quantization to the integers
  in ``[-127, 127]`` / ``[-7, 7]``, one ``(scale, zero)`` pair per
  `SCALE_BLOCK` coordinates; ``int4`` packs two codes a byte.  The step is
  the reference's, operation for operation: the uniform is drawn on the
  blocked ``[..., S, 128]`` shape from the second half of ``split(key)``;
  codes are ``clip(floor(fma(xb / safe, levels, u)), -levels, levels)``
  with ``xb / safe`` a true division and the multiply by ``levels``
  fused into the add of the uniform (one rounding: XLA contracts them;
  ``tools/xla_divisor_forms.py``); the scale is ``safe * float32(1/levels)``
  (XLA folds the constant divisor ``safe / levels`` into that multiply).
* ``topk<P>`` / ``randk<P>`` — keep ``P`` percent of the coordinates
  (float32 values, or quantized by an ``_int8`` / ``_int4`` suffix).
  ``topk`` keeps the largest ``|x|`` and ships the subset's
  combinatorial rank (``ceil(log2 C(d, k))`` bits); ``randk`` draws its
  set from the shared per-tick key and ships no index bits: the decoder
  re-derives it (`Codec.randk_indices`) and never trusts ``msg.idx``.

Codes, scales, indices and decodes equal the reference's bit for bit under
the same key.  A key may also be ``[E, 2]`` row keys over an ``[E, d]``
message tensor (`repro_torch.prng`): each row is then encoded under its
own key, the reference's ``vmap`` over the links of the network runtime.
Both selections are a stable descending sort sliced to
``k``: ``lax.top_k`` returns values in descending order with ties broken
by the lower index, which ``torch.topk`` does not promise on a card, and
the kept values' order fixes which uniform each one's rounding draws.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import ops, ref

SCALE_BLOCK = ref.SCALE_BLOCK
_SPARSE_RE = re.compile(r"^(topk|randk)(\d{1,2})(?:_int(8|4))?$")


class WireMsg(NamedTuple):
    """One codeword: ``payload`` int8 ``[..., P]`` (raw float bits for
    32-bit values, one code per kept coordinate for ``int8``, two packed
    nibbles a byte for ``int4``), ``scale`` float32 ``[..., S, 2]``
    per-block ``(scale, zero)`` pairs, ``idx`` int32 ``[..., K]`` the kept
    coordinates of a sparse codec (``K = 0`` for the dense modes)."""

    payload: torch.Tensor
    scale: torch.Tensor
    idx: torch.Tensor


def _blocked(x: torch.Tensor) -> torch.Tensor:
    """``[..., k] -> [..., S, SCALE_BLOCK]``, the ragged tail zero-padded."""
    k = x.shape[-1]
    s = -(-k // SCALE_BLOCK)
    pad = s * SCALE_BLOCK - k
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape((*x.shape[:-1], s, SCALE_BLOCK))


def _quantize(key: np.ndarray, x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric stochastic quantization of ``x [..., k]`` to ``bits`` (8
    or 4) signed levels: ``(q int8 [..., k], scale float32 [..., S, 2])``."""
    levels = (1 << (bits - 1)) - 1
    k = x.shape[-1]
    xb = _blocked(x)
    s = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    safe = torch.where(s > 0, s, 1.0)
    u = prng.uniform(key, xb.shape, x.device)
    # XLA contracts the multiply into the add of the uniform: one rounding
    q = torch.clamp(torch.floor(ref.fma_f32(xb / safe, float(levels), u)), -float(levels),
                    float(levels))
    q = q.reshape((*x.shape[:-1], -1))[..., :k].to(torch.int8).contiguous()
    scale0 = (safe * float(np.float32(1.0 / levels)))[..., 0]
    return q, torch.stack([scale0, torch.zeros_like(scale0)], dim=-1)


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., k]`` codes in ``[-7, 7]`` -> int8 ``[..., ceil(k/2)]``,
    code ``2i`` in the low nibble of byte ``i`` and ``2i + 1`` in the high."""
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    lo = q[..., 0::2].to(torch.int32) & 0xF
    hi = q[..., 1::2].to(torch.int32) & 0xF
    packed = lo | (hi << 4)
    return torch.where(packed >= 128, packed - 256, packed).to(torch.int8)


def unpack_nibbles(b: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of `pack_nibbles`: each 4-bit field sign-extended, ``k``
    int8 codes in ``[-8, 7]``."""
    w = b.to(torch.int32)
    lo = ((w & 0xF) ^ 8) - 8
    hi = (((w >> 4) & 0xF) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-1).reshape((*b.shape[:-1], 2 * b.shape[-1]))
    return out[..., :k].to(torch.int8).contiguous()


@functools.cache
def _subset_rank_bits(d: int, k: int) -> int:
    """``ceil(log2 C(d, k))``: the size of a combinatorial-number-system
    rank of a k-subset of d coordinates."""
    return max(1, (math.comb(d, k) - 1).bit_length())


def top_indices(v: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(v, k)``'s indices: the ``k`` largest of float32
    ``v [..., d]`` in descending order, ties to the lower index, int32.
    ``lax.top_k`` orders floats totally (``-0 < +0``), so the sort runs on
    the integer key of that order, stably."""
    bits = v.contiguous().view(torch.int32)
    total = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    order = torch.sort(total, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32).contiguous()


def scatter_last(idx: torch.Tensor, vals: torch.Tensor, d: int) -> torch.Tensor:
    """``vals [..., k]`` written at ``idx [..., k]`` into zeros ``[..., d]``;
    where indices repeat (a forged codeword), the last slot wins, as XLA's
    scatter does on the CPU.  Written so on every device: only each
    position's last writer is stored, so the result does not depend on the
    order a card's scatter happens to take."""
    lead = idx.shape[:-1]
    k = idx.shape[-1]
    n = int(math.prod(lead)) if lead else 1
    pos = idx.reshape(n, k).long() + d * torch.arange(n, device=idx.device)[:, None]
    srt, order = torch.sort(pos, dim=1, stable=True)
    last = torch.ones_like(srt, dtype=torch.bool)
    last[:, :-1] = srt[:, 1:] != srt[:, :-1]
    out = torch.zeros(n * d, dtype=vals.dtype, device=vals.device)
    src = vals.reshape(n, k).gather(1, order)
    out[srt[last]] = src[last]
    return out.reshape((*lead, d))


@dataclasses.dataclass(frozen=True)
class Codec:
    """One wire format: ``mode`` in {dense, topk, randk}, value precision
    ``bits`` in {32, 8, 4}, kept fraction ``k_frac`` (sparse modes)."""

    name: str
    mode: str = "dense"
    bits: int = 32
    k_frac: float = 1.0

    @property
    def lossless(self) -> bool:
        """True when decode(encode(x)) == x bit for bit (no carry needed)."""
        return self.mode == "dense" and self.bits == 32

    def kept(self, d: int) -> int:
        """Coordinates that survive encoding a ``[d]`` message."""
        if self.mode == "dense":
            return d
        return max(1, min(d, round(self.k_frac * d)))

    def index_bits(self, d: int) -> int:
        """Wire bits of the index set: the topk subset's rank; randk's set
        is re-derived from the shared key (0 bits)."""
        if self.mode != "topk":
            return 0
        return _subset_rank_bits(d, self.kept(d))

    def payload_bytes(self, d: int) -> int:
        """Bytes of the payload buffer (value bytes only)."""
        k = self.kept(d)
        if self.bits == 32:
            return 4 * k
        if self.bits == 8:
            return k
        return (k + 1) // 2

    def nscales(self, d: int) -> int:
        """Dequantization pairs on the wire (one unit pair, not sent, for
        float32 values)."""
        return 1 if self.bits == 32 else -(-self.kept(d) // SCALE_BLOCK)

    def wire_bits(self, d: int) -> int:
        """Exact bits on the wire per message: value bits, the index set's
        rank, and one 32-bit scale per `SCALE_BLOCK` quantized coordinates
        (the nibble pad byte is not charged)."""
        bits = self.kept(d) * self.bits + self.index_bits(d)
        if self.bits < 32:
            bits += 32 * self.nscales(d)
        return bits

    def randk_indices(self, key: np.ndarray, lead: tuple[int, ...], d: int,
                      device: str | torch.device) -> torch.Tensor:
        """The randk set both sides draw: the top ``k`` of uniforms shaped
        ``lead + (d,)`` under the first half of ``split(key)``."""
        if self.mode != "randk":
            raise ValueError(f"codec {self.name!r} has no shared-randomness indices")
        k_sel = prng.split(key)[..., 0, :]
        return top_indices(prng.uniform(k_sel, (*lead, d), device), self.kept(d))

    def encode(self, key: np.ndarray, x: torch.Tensor) -> WireMsg:
        """``x [..., d]`` float32 -> `WireMsg`."""
        d = x.shape[-1]
        lead = tuple(x.shape[:-1])
        k_q = prng.split(key)[..., 1, :]
        if self.mode == "dense":
            idx = torch.zeros((*lead, 0), dtype=torch.int32, device=x.device)
            vals = x
        else:
            if self.mode == "topk":
                idx = top_indices(torch.abs(x), self.kept(d))
            else:
                idx = self.randk_indices(key, lead, d, x.device)
            vals = torch.gather(x, -1, idx.long())
        if self.bits == 32:
            unit = torch.tensor([[1.0, 0.0]], device=x.device).expand((*lead, 1, 2)).contiguous()
            return WireMsg(vals.contiguous().view(torch.int8), unit, idx)
        q, scale = _quantize(k_q, vals, self.bits)
        return WireMsg(q if self.bits == 8 else pack_nibbles(q), scale, idx)

    def codes(self, msg: WireMsg, d: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The quantized values' int8 codes ``[n, k]`` and scales
        ``[n, S, 2]``, leading axes flattened (``int4`` unpacked)."""
        k = self.kept(d)
        raw = msg.payload[..., : self.payload_bytes(d)]
        q = raw if self.bits == 8 else unpack_nibbles(raw, k)
        return (q.reshape(-1, k).contiguous(),
                msg.scale[..., : self.nscales(d), :].reshape(-1, self.nscales(d), 2).contiguous())

    def support(self, msg: WireMsg, d: int, key: np.ndarray | None = None) -> torch.Tensor:
        """The kept coordinates of a sparse codeword: re-derived from the
        shared key for randk (when given one), else ``msg.idx``."""
        lead = tuple(msg.payload.shape[:-1])
        if self.mode == "randk" and key is not None:
            return self.randk_indices(key, lead, d, msg.payload.device)
        return msg.idx[..., : self.kept(d)]

    def decode(self, msg: WireMsg, d: int, key: np.ndarray | None = None) -> torch.Tensor:
        """`WireMsg` -> ``x_hat [..., d]``: the float bits back, or
        ``q * scale + zero`` rounded once by the ``dequant`` kernel on a card
        and its plain version on the CPU (a NaN, an inf scale times a zero
        code, comes back as +inf, as screening reads it); a sparse codec
        scatters its kept values into zeros at `support`.  The trainer
        decodes the dense modes with the carry instead
        (`repro_torch.comm.exchange.decode`)."""
        k = self.kept(d)
        lead = tuple(msg.payload.shape[:-1])
        if self.bits == 32:
            vals = msg.payload[..., : 4 * k].contiguous().view(torch.float32)
        else:
            vals = ops.dequant(*self.codes(msg, d)).reshape((*lead, k))
        if self.mode == "dense":
            return vals
        return scatter_last(self.support(msg, d, key), vals, d)


@functools.cache
def get_codec(name: str) -> Codec:
    """Resolve a codec name: ``identity``, ``int8``, ``int4``, or
    ``topk<P>`` / ``randk<P>`` (P = percent kept, 1-99) with an optional
    ``_int8`` / ``_int4`` suffix, e.g. ``topk50_int8``."""
    if name == "identity":
        return Codec(name)
    if name == "int8":
        return Codec(name, bits=8)
    if name == "int4":
        return Codec(name, bits=4)
    m = _SPARSE_RE.match(name)
    if m:
        mode, pct, bits = m.group(1), int(m.group(2)), m.group(3)
        if not 1 <= pct <= 99:
            raise ValueError(f"codec {name!r}: kept percentage must be 1-99")
        return Codec(name, mode=mode, bits=int(bits) if bits else 32, k_frac=pct / 100.0)
    raise ValueError(f"unknown codec {name!r}; options: identity, int8, int4, "
                     f"topk<P>[_int8|_int4], randk<P>[_int8|_int4] (P = percent kept)")


def codec_bank(names) -> tuple[Codec, ...]:
    """The static bank of the named codecs, in order."""
    return tuple(get_codec(n) for n in names)


def codec_names() -> list[str]:
    """The reference's fixed registry names."""
    return ["identity", "int8", "int4", "topk25", "randk25", "topk25_int8"]
