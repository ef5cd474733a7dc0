"""Fused int8-codeword screening, dense layout — the wrappers of the CUDA
kernels ``dequant_screen_trimmed_mean_dense`` and
``dequant_screen_median_dense`` (``csrc/dequant_screen.cu``), which replace
the TPU kernels `repro.kernels.dequant_screen.dequant_trimmed_mean_pallas`
and ``dequant_median_pallas``.

The operands are the broadcast codewords of the port's int8 codec
(``q [M, d]`` int8, ``scale [M, S, 2]`` float32; `repro_torch.comm.codec`),
the ``[M, M]`` in-neighbor mask and ``self_vals [M, d]``: node j screens
its in-neighbors' codewords against its own uncompressed value, the
reference's per-node kernel over E = M views of one broadcast.  The result
is `ref.dequant` followed by the float screen (`ref.dequant_trimmed_mean_dense`,
`ref.dequant_median_dense`), without the decoded bank in device memory.
A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises: the register kernel up to `MAX_ROWS` rows to sort, the wide path
(`screen_wide`) above.  Each wrapper's ``launches`` counts its register
kernel's launches and nothing else; ``screen_wide.launch.launches`` the
wide path's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref, screen_wide
from repro_torch.kernels.dequant import check_codeword_rows
from repro_torch.kernels.median import MAX_ROWS


def check_codeword_screen(q: torch.Tensor, scale: torch.Tensor, adj: torch.Tensor,
                          self_vals: torch.Tensor) -> None:
    """Validate the dense codeword-screen operands: `check_codeword_rows`
    and the mask (`build.check_screen_args`)."""
    check_codeword_rows(q, scale, self_vals)
    build.check_screen_args(self_vals, adj, self_vals)


def _launch(name: str, rows: int, *args) -> bool:
    """Launch ``name``'s register kernel, or its wide twin above `MAX_ROWS`
    rows to sort; returns whether the register kernel ran."""
    if rows > MAX_ROWS:
        screen_wide.launch(name.replace("dequant_screen_", "dequant_screen_wide_"), rows, *args)
        return False
    build.check_launch(getattr(build.load(), name)(*args), name)
    return True


def dequant_screen_trimmed_mean_dense(q: torch.Tensor, scale: torch.Tensor, adj: torch.Tensor,
                                      self_vals: torch.Tensor, b: int) -> torch.Tensor:
    """Trimmed-mean screening of the decoded codewords at every node;
    returns ``[M, d]`` float32."""
    check_codeword_screen(q, scale, adj, self_vals)
    if b < 0:
        raise ValueError(f"b must be >= 0, got {b}")
    if q.device.type == "cpu":
        return ref.dequant_trimmed_mean_dense(q, scale, adj, self_vals, b)
    if q.device.type != "cuda":
        raise ValueError(f"no codeword trimmed-mean kernel for device {q.device}")
    m, d = q.shape
    out = torch.empty_like(self_vals)
    if _launch("dequant_screen_trimmed_mean_dense", m, q.data_ptr(), scale.data_ptr(),
               adj.data_ptr(), self_vals.data_ptr(), out.data_ptr(), m, d, scale.shape[1], int(b),
               build.stream_of(q)):
        dequant_screen_trimmed_mean_dense.launches += 1
    return out


def dequant_screen_median_dense(q: torch.Tensor, scale: torch.Tensor, adj: torch.Tensor,
                                self_vals: torch.Tensor) -> torch.Tensor:
    """Median screening of the decoded codewords and the node's own value
    at every node; returns ``[M, d]`` float32."""
    check_codeword_screen(q, scale, adj, self_vals)
    if q.device.type == "cpu":
        return ref.dequant_median_dense(q, scale, adj, self_vals)
    if q.device.type != "cuda":
        raise ValueError(f"no codeword median kernel for device {q.device}")
    m, d = q.shape
    out = torch.empty_like(self_vals)
    if _launch("dequant_screen_median_dense", m + 1, q.data_ptr(), scale.data_ptr(),
               adj.data_ptr(), self_vals.data_ptr(), out.data_ptr(), m, d, scale.shape[1],
               build.stream_of(q)):
        dequant_screen_median_dense.launches += 1
    return out


dequant_screen_trimmed_mean_dense.launches = 0
dequant_screen_median_dense.launches = 0
