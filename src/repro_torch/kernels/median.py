"""BRIDGE-M dense screening — the wrapper of the CUDA kernel
``screen_median_dense`` (``csrc/screen.cu``), which replaces the TPU kernel
`repro.kernels.median.median_pallas`.

A CPU tensor goes to the plain version (`ref.median_dense`); a CUDA tensor
launches the kernel or raises: the register kernel up to `MAX_ROWS` rows
(M + 1), the wide path (`screen_wide`, ``screen_wide_median_dense``)
above.  ``median_dense.launches`` counts the register kernel's launches
and nothing else; ``screen_wide.launch.launches`` the wide path's.

The experiment axis: ``w`` and ``self_vals`` ``[E, M, d]`` under one shared
adjacency screen E experiments in one launch; ``[M, d]`` is E = 1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, networks, ref, screen_wide

# Rows the register kernel sorts per column: the M senders plus the node
# itself (its largest network holds 128).
MAX_ROWS = networks.MAX_ROWS


def median_dense(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median screening of the broadcast ``w [M, d]`` at
    every node over its in-neighbors (``adj [M, M]``) and itself
    (``self_vals [M, d]``); returns ``[M, d]`` float32."""
    build.check_screen_args(w, adj, self_vals)
    if w.device.type == "cpu":
        return ref.median_dense(w, adj, self_vals)
    if w.device.type != "cuda":
        raise ValueError(f"no median kernel for device {w.device}")
    m, d = w.shape[-2:]
    out = torch.empty_like(w)
    args = (w.data_ptr(), adj.data_ptr(), self_vals.data_ptr(), out.data_ptr(), m, d,
            *build.experiments(w, adj), build.stream_of(w))
    if m + 1 > MAX_ROWS:
        screen_wide.launch("screen_wide_median_dense", m + 1, *args)
        return out
    err = build.load().screen_median_dense(*args)
    build.check_launch(err, "screen_median_dense")
    median_dense.launches += 1
    return out


median_dense.launches = 0
