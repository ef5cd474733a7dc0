"""int8 codeword decode — the wrappers of the CUDA kernels ``dequant`` and
``dequant_carry`` (``csrc/dequant.cu``), which replace the TPU kernel
`repro.kernels.dequant_screen.dequant_pallas`.

A codeword is ``q [n, d]`` int8 codes and ``scale [n, S, 2]`` float32,
one ``(scale, zero)`` pair per `ref.SCALE_BLOCK` coordinates
(`repro_torch.comm.codec`).  `dequant` decodes it (NaN -> +inf, or
kept NaN where the caller asks, as the sharded gossip's plain product);
`dequant_carry` is the trainer's decode, which also advances the codec's
error-feedback carry (see `ref.dequant_carry` for its rounding).  A CPU
tensor goes to the plain version; a CUDA tensor launches the kernel or
raises.  Each wrapper's ``launches`` counts kernel launches and nothing
else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


def check_codeword(q: torch.Tensor, scale: torch.Tensor) -> None:
    """Validate an int8 codeword: contiguous int8 ``q [n, d]`` and float32
    ``scale [n, ceil(d / 128), 2]`` on one device."""
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequant takes int8 codes and float32 scales, got {q.dtype}, {scale.dtype}")
    if q.ndim != 2:
        raise ValueError(f"q must be [n, d], got {tuple(q.shape)}")
    n, d = q.shape
    nblk = -(-d // ref.SCALE_BLOCK)
    if scale.shape != (n, nblk, 2):
        raise ValueError(f"scale {tuple(scale.shape)} must be [{n}, {nblk}, 2] for q {tuple(q.shape)}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("codeword operands must be contiguous")
    if q.device != scale.device:
        raise ValueError(f"operands on different devices: {q.device}, {scale.device}")


def check_codeword_rows(q: torch.Tensor, scale: torch.Tensor, self_vals: torch.Tensor) -> None:
    """Validate a codeword screen's codewords and own values: a codeword
    (`check_codeword`) and contiguous float32 ``self_vals`` of ``q``'s shape
    on ``q``'s device."""
    check_codeword(q, scale)
    build.check_rows(self_vals, self_vals)
    if self_vals.shape != q.shape or self_vals.device != q.device:
        raise ValueError(f"self_vals {tuple(self_vals.shape)} on {self_vals.device} must match "
                         f"q {tuple(q.shape)} on {q.device}")


def dequant(q: torch.Tensor, scale: torch.Tensor, keep_nan: bool = False) -> torch.Tensor:
    """``q * scale + zero`` per coordinate, rounded once; NaN -> +inf
    unless ``keep_nan``.  Returns ``[n, d]`` float32."""
    check_codeword(q, scale)
    if q.device.type == "cpu":
        return ref.dequant(q, scale, keep_nan)
    if q.device.type != "cuda":
        raise ValueError(f"no dequant kernel for device {q.device}")
    n, d = q.shape
    out = torch.empty((n, d), dtype=torch.float32, device=q.device)
    err = build.load().dequant(q.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d,
                               scale.shape[1], int(bool(keep_nan)), build.stream_of(q))
    build.check_launch(err, "dequant")
    dequant.launches += 1
    return out


def dequant_carry(q: torch.Tensor, scale: torch.Tensor, est: torch.Tensor,
                  target: torch.Tensor, zero_folded: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The trainer's decode of the codeword with its carry: returns
    ``(x_hat, resid)``, both ``[n, d]`` float32 (`ref.dequant_carry`,
    which says what ``zero_folded`` selects)."""
    check_codeword(q, scale)
    build.check_rows(est, target)
    if est.shape != q.shape or est.device != q.device:
        raise ValueError(f"est/target {tuple(est.shape)} on {est.device} must match "
                         f"q {tuple(q.shape)} on {q.device}")
    if q.device.type == "cpu":
        return ref.dequant_carry(q, scale, est, target, zero_folded)
    if q.device.type != "cuda":
        raise ValueError(f"no dequant kernel for device {q.device}")
    n, d = q.shape
    x_hat = torch.empty_like(est)
    resid = torch.empty_like(est)
    err = build.load().dequant_carry(q.data_ptr(), scale.data_ptr(), est.data_ptr(),
                                     target.data_ptr(), x_hat.data_ptr(), resid.data_ptr(), n, d,
                                     scale.shape[1], int(bool(zero_folded)), build.stream_of(q))
    build.check_launch(err, "dequant_carry")
    dequant_carry.launches += 1
    return x_hat, resid


dequant.launches = 0
dequant_carry.launches = 0
