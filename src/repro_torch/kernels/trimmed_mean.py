"""BRIDGE-T dense screening — the wrapper of the CUDA kernel
``screen_trimmed_mean_dense`` (``csrc/screen.cu``), which replaces the TPU
kernel `repro.kernels.trimmed_mean.trimmed_mean_pallas`.

A CPU tensor goes to the plain version (`ref.trimmed_mean_dense`); a CUDA
tensor launches the kernel or raises.  ``trimmed_mean_dense.launches``
counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

# Rows the kernel sorts per column: the M senders (its largest register
# network holds 128).
MAX_ROWS = 128


def trimmed_mean_dense(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor,
                       b: int, recip: bool = False) -> torch.Tensor:
    """Trimmed-mean screening of the broadcast ``w [M, d]`` at every node
    under the in-neighbor mask ``adj [M, M]`` with own values
    ``self_vals [M, d]``; returns ``[M, d]`` float32.  ``recip`` multiplies
    the kept total by the float32 reciprocal of its divisor instead of
    dividing (`ref.trimmed_mean_views`)."""
    build.check_screen_args(w, adj, self_vals)
    if b < 0:
        raise ValueError(f"b must be >= 0, got {b}")
    if w.device.type == "cpu":
        return ref.trimmed_mean_dense(w, adj, self_vals, b, recip)
    if w.device.type != "cuda":
        raise ValueError(f"no trimmed-mean kernel for device {w.device}")
    m, d = w.shape
    if m > MAX_ROWS:
        raise ValueError(f"trimmed-mean kernel sorts at most {MAX_ROWS} rows, got M={m}")
    out = torch.empty_like(w)
    lib = build.load()
    err = lib.screen_trimmed_mean_dense(w.data_ptr(), adj.data_ptr(), self_vals.data_ptr(),
                                        out.data_ptr(), m, d, int(b), int(bool(recip)),
                                        build.stream_of(w))
    build.check_launch(err, "screen_trimmed_mean_dense")
    trimmed_mean_dense.launches += 1
    return out


trimmed_mean_dense.launches = 0
