"""Wire codecs: what travels on an edge per tick — port of the dense modes
of `repro.comm.codec` (``identity`` and ``int8``).

A `Codec` turns the flattened iterate ``x [..., d]`` into a `WireMsg` and
back; ``wire_bits(d)`` is the exact bits on the wire per message.

* ``identity`` — an exact float32 bitcast (lossless: the trainer skips the
  wire for it altogether, so its path stays structurally untouched).
* ``int8`` — symmetric stochastic quantization to the integers in
  ``[-127, 127]``, one ``(scale, zero)`` pair per `SCALE_BLOCK` coordinates.
  The step is the reference's, operation for operation: the uniform is
  drawn on the blocked ``[..., S, 128]`` shape from the second half of
  ``split(key)``; codes are ``clip(floor(xb / safe * 127 + u), -127, 127)``
  with ``xb / safe`` a true division; the scale is ``safe * float32(1/127)``
  (XLA folds the constant divisor ``safe / 127`` into that multiply).  Codes
  and scales equal the reference's bit for bit under the same key.

``int4``, ``topk<P>``, ``randk<P>`` and their combinations are not ported
yet (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import ops, ref

SCALE_BLOCK = ref.SCALE_BLOCK
_NOT_PORTED = "not ported yet: ROADMAP Queue 1 item 6"
_SPARSE_RE = re.compile(r"^(topk|randk)(\d{1,2})(?:_int(8|4))?$")
_INV_LEVELS = float(np.float32(1.0 / 127.0))


class WireMsg(NamedTuple):
    """One codeword: ``payload`` int8 ``[..., P]`` (raw float bits for
    ``identity``, one code per coordinate for ``int8``), ``scale`` float32
    ``[..., S, 2]`` per-block ``(scale, zero)`` pairs, ``idx`` int32
    ``[..., 0]`` (the dense modes send no indices)."""

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


@dataclasses.dataclass(frozen=True)
class Codec:
    """One dense wire format: value precision ``bits`` in {32, 8}."""

    name: str
    bits: int = 32

    @property
    def lossless(self) -> bool:
        """True when decode(encode(x)) == x bit for bit (no carry needed)."""
        return self.bits == 32

    def kept(self, d: int) -> int:
        """Coordinates that survive encoding a ``[d]`` message (all)."""
        return d

    def payload_bytes(self, d: int) -> int:
        """Bytes of the payload buffer (value bytes only)."""
        return 4 * d if self.bits == 32 else d

    def nscales(self, d: int) -> int:
        """Dequantization pairs on the wire (one unit pair, not sent, for
        float32 values)."""
        return 1 if self.bits == 32 else -(-d // SCALE_BLOCK)

    def wire_bits(self, d: int) -> int:
        """Exact bits on the wire per message: value bits plus one 32-bit
        scale per `SCALE_BLOCK` quantized coordinates."""
        bits = d * self.bits
        if self.bits < 32:
            bits += 32 * self.nscales(d)
        return bits

    def encode(self, key: np.ndarray, x: torch.Tensor) -> WireMsg:
        """``x [..., d]`` float32 -> `WireMsg`."""
        lead = x.shape[:-1]
        _, k_q = prng.split(key)
        idx = torch.zeros((*lead, 0), dtype=torch.int32, device=x.device)
        if self.bits == 32:
            unit = torch.tensor([[1.0, 0.0]], device=x.device).expand((*lead, 1, 2)).contiguous()
            return WireMsg(x.contiguous().view(torch.int8), unit, idx)
        d = x.shape[-1]
        xb = _blocked(x)
        s = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
        safe = torch.where(s > 0, s, 1.0)
        u = prng.uniform(k_q, xb.shape, x.device)
        q = torch.clamp(torch.floor(xb / safe * 127.0 + u), -127.0, 127.0)
        q = q.reshape((*lead, -1))[..., :d].to(torch.int8).contiguous()
        scale0 = (safe * _INV_LEVELS)[..., 0]
        return WireMsg(q, torch.stack([scale0, torch.zeros_like(scale0)], dim=-1), idx)

    def decode(self, msg: WireMsg, d: int) -> torch.Tensor:
        """`WireMsg` -> ``x_hat [..., d]``: the float bits back, or
        ``q * scale + zero`` rounded once (XLA's fused multiply-add) by the
        ``dequant`` kernel on a card and its plain version on the CPU; a NaN
        (an inf scale times a zero code) comes back as +inf, as screening
        reads it.  The trainer decodes with the carry instead
        (`repro_torch.comm.exchange.decode`)."""
        if self.bits == 32:
            return msg.payload[..., : 4 * d].contiguous().view(torch.float32)
        lead = msg.payload.shape[:-1]
        q = msg.payload[..., :d].reshape(-1, d).contiguous()
        scale = msg.scale.reshape(q.shape[0], -1, 2).contiguous()
        return ops.dequant(q, scale).reshape((*lead, d))


def get_codec(name: str) -> Codec:
    """Resolve a codec name: ``identity`` or ``int8``."""
    if name == "identity":
        return Codec(name)
    if name == "int8":
        return Codec(name, bits=8)
    if name == "int4" or _SPARSE_RE.match(name):
        raise NotImplementedError(f"codec {name!r}: {_NOT_PORTED}")
    raise ValueError(f"unknown codec {name!r}; options: identity, int8 (int4, topk<P>, randk<P>: "
                     f"{_NOT_PORTED})")
