"""BRIDGE-T dense screening — the wrapper of the CUDA kernel
``screen_trimmed_mean_dense`` (``csrc/screen.cu``), which replaces the TPU
kernel `repro.kernels.trimmed_mean.trimmed_mean_pallas`.

A CPU tensor goes to the plain version (`ref.trimmed_mean_dense`); a CUDA
tensor launches the kernel or raises: the register kernel up to `MAX_ROWS`
senders, the wide path (`screen_wide`, ``screen_wide_trimmed_mean_dense``)
above.  ``trimmed_mean_dense.launches`` counts the register kernel's
launches and nothing else; ``screen_wide.launch.launches`` the wide path's.

The experiment axis: ``w`` and ``self_vals`` ``[E, M, d]`` under one shared
adjacency, ``b`` an int or an int32 ``[E]`` tensor, screen E experiments in
one launch, each as its own ``[M, d]`` call computes it; the ``[M, d]``
form is the E = 1 case.  ``adj`` may also be ``[E, M, M]``, a mask an
experiment (Bulyan's selections).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, networks, ref, screen_wide

# Rows the register kernel sorts per column: the M senders (its largest
# network holds 128).
MAX_ROWS = networks.MAX_ROWS


def trimmed_mean_dense(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor,
                       b, recip: bool = False) -> torch.Tensor:
    """Trimmed-mean screening of the broadcast ``w [M, d]`` at every node
    under the in-neighbor mask ``adj [M, M]`` with own values
    ``self_vals [M, d]``; returns ``[M, d]`` float32 (``[E, M, d]`` over
    the experiment axis).  ``recip`` multiplies the kept total by the
    float32 reciprocal of its divisor instead of dividing
    (`ref.trimmed_mean_views`)."""
    build.check_screen_args(w, adj, self_vals)
    build.check_b(b, w)
    if w.device.type == "cpu":
        return ref.trimmed_mean_dense(w, adj, self_vals, b, recip)
    if w.device.type != "cuda":
        raise ValueError(f"no trimmed-mean kernel for device {w.device}")
    m, d = w.shape[-2:]
    out = torch.empty_like(w)
    b0, *exps = build.experiments(w, adj, b)
    args = (w.data_ptr(), adj.data_ptr(), self_vals.data_ptr(), out.data_ptr(), m, d, b0,
            int(bool(recip)), *exps, build.stream_of(w))
    if m > MAX_ROWS:
        screen_wide.launch("screen_wide_trimmed_mean_dense", m, *args)
        return out
    err = build.load().screen_trimmed_mean_dense(*args)
    build.check_launch(err, "screen_trimmed_mean_dense")
    trimmed_mean_dense.launches += 1
    return out


trimmed_mean_dense.launches = 0
