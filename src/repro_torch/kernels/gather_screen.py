"""Sparse-layout screening — the wrappers of the CUDA kernels
``gather_screen_trimmed_mean`` and ``gather_screen_median``, which replace
the TPU kernel `repro.kernels.gather_screen.gather_screen_pallas`, and
``gather_dequant_screen_trimmed_mean`` and
``gather_dequant_screen_median``, which replace
``gather_dequant_screen_pallas`` (all in ``csrc/gather_screen.cu``).

Node j screens the rows of the broadcast ``w [M, d]`` — or of the int8
codewords ``q [M, d]`` / ``scale [M, S, 2]``, decoded in registers — named
by row j of the neighbor table (``safe_idx [M, K]`` int32, ``valid [M, K]``
bool/uint8; `repro_torch.core.neighbors.NeighborTable`) against its own
``self_vals [M, d]``.  A CPU tensor goes to the plain version
(`ref.gather_trimmed_mean`, `ref.gather_median`,
`ref.gather_dequant_trimmed_mean`, `ref.gather_dequant_median`); a CUDA
tensor launches the kernel or raises.  Each wrapper's ``launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.dequant import check_codeword_rows

# Table slots the kernels take: they sort K rows (K + 1 for the median) in a
# register network of at most 64, the reference's sequential-sum bound.
MAX_SLOTS = 63


def check_gather_args(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                      self_vals: torch.Tensor) -> None:
    """Validate the sparse screening operands: `build.check_rows`, a
    contiguous int32 ``[M, K]`` index table and a bool/uint8 mask of its
    shape, all on one device."""
    build.check_rows(w, self_vals)
    if safe_idx.dtype != torch.int32:
        raise TypeError(f"safe_idx must be int32, got {safe_idx.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    if safe_idx.ndim != 2 or safe_idx.shape[0] != w.shape[0] or valid.shape != safe_idx.shape:
        raise ValueError(f"safe_idx {tuple(safe_idx.shape)} and valid {tuple(valid.shape)} "
                         f"must be one [M={w.shape[0]}, K]")
    if not (safe_idx.is_contiguous() and valid.is_contiguous()):
        raise ValueError("neighbor table operands must be contiguous")
    if not (w.device == safe_idx.device == valid.device):
        raise ValueError(f"operands on different devices: {w.device}, {safe_idx.device}, "
                         f"{valid.device}")


def _launch_target(w: torch.Tensor, k: int, name: str) -> None:
    if w.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {w.device}")
    if k > MAX_SLOTS:
        raise ValueError(f"{name} kernel takes at most {MAX_SLOTS} table slots, got K={k}")


def gather_screen_trimmed_mean(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                               self_vals: torch.Tensor, b: int) -> torch.Tensor:
    """Trimmed-mean screening of every node over its table slots; returns
    ``[M, d]`` float32."""
    check_gather_args(w, safe_idx, valid, self_vals)
    if b < 0:
        raise ValueError(f"b must be >= 0, got {b}")
    if w.device.type == "cpu":
        return ref.gather_trimmed_mean(w, safe_idx, valid, self_vals, b)
    m, d = w.shape
    k = safe_idx.shape[1]
    _launch_target(w, k, "gather_screen_trimmed_mean")
    out = torch.empty_like(w)
    err = build.load().gather_screen_trimmed_mean(
        w.data_ptr(), safe_idx.data_ptr(), valid.data_ptr(), self_vals.data_ptr(), out.data_ptr(),
        m, k, d, int(b), build.stream_of(w))
    build.check_launch(err, "gather_screen_trimmed_mean")
    gather_screen_trimmed_mean.launches += 1
    return out


def gather_screen_median(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                         self_vals: torch.Tensor) -> torch.Tensor:
    """Median screening of every node over its table slots and itself;
    returns ``[M, d]`` float32."""
    check_gather_args(w, safe_idx, valid, self_vals)
    if w.device.type == "cpu":
        return ref.gather_median(w, safe_idx, valid, self_vals)
    m, d = w.shape
    k = safe_idx.shape[1]
    _launch_target(w, k, "gather_screen_median")
    out = torch.empty_like(w)
    err = build.load().gather_screen_median(
        w.data_ptr(), safe_idx.data_ptr(), valid.data_ptr(), self_vals.data_ptr(), out.data_ptr(),
        m, k, d, build.stream_of(w))
    build.check_launch(err, "gather_screen_median")
    gather_screen_median.launches += 1
    return out


def check_gather_codeword(q: torch.Tensor, scale: torch.Tensor, safe_idx: torch.Tensor,
                          valid: torch.Tensor, self_vals: torch.Tensor) -> None:
    """Validate the sparse codeword-screen operands: `check_codeword_rows`
    and the table (`check_gather_args`)."""
    check_codeword_rows(q, scale, self_vals)
    check_gather_args(self_vals, safe_idx, valid, self_vals)


def gather_dequant_screen_trimmed_mean(q: torch.Tensor, scale: torch.Tensor,
                                       safe_idx: torch.Tensor, valid: torch.Tensor,
                                       self_vals: torch.Tensor, b: int) -> torch.Tensor:
    """Trimmed-mean screening of every node over its table slots' decoded
    codewords; returns ``[M, d]`` float32."""
    check_gather_codeword(q, scale, safe_idx, valid, self_vals)
    if b < 0:
        raise ValueError(f"b must be >= 0, got {b}")
    if q.device.type == "cpu":
        return ref.gather_dequant_trimmed_mean(q, scale, safe_idx, valid, self_vals, b)
    m, d = q.shape
    k = safe_idx.shape[1]
    _launch_target(q, k, "gather_dequant_screen_trimmed_mean")
    out = torch.empty_like(self_vals)
    err = build.load().gather_dequant_screen_trimmed_mean(
        q.data_ptr(), scale.data_ptr(), safe_idx.data_ptr(), valid.data_ptr(),
        self_vals.data_ptr(), out.data_ptr(), m, k, d, scale.shape[1], int(b), build.stream_of(q))
    build.check_launch(err, "gather_dequant_screen_trimmed_mean")
    gather_dequant_screen_trimmed_mean.launches += 1
    return out


def gather_dequant_screen_median(q: torch.Tensor, scale: torch.Tensor, safe_idx: torch.Tensor,
                                 valid: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """Median screening of every node over its table slots' decoded
    codewords and itself; returns ``[M, d]`` float32."""
    check_gather_codeword(q, scale, safe_idx, valid, self_vals)
    if q.device.type == "cpu":
        return ref.gather_dequant_median(q, scale, safe_idx, valid, self_vals)
    m, d = q.shape
    k = safe_idx.shape[1]
    _launch_target(q, k, "gather_dequant_screen_median")
    out = torch.empty_like(self_vals)
    err = build.load().gather_dequant_screen_median(
        q.data_ptr(), scale.data_ptr(), safe_idx.data_ptr(), valid.data_ptr(),
        self_vals.data_ptr(), out.data_ptr(), m, k, d, scale.shape[1], build.stream_of(q))
    build.check_launch(err, "gather_dequant_screen_median")
    gather_dequant_screen_median.launches += 1
    return out


gather_screen_trimmed_mean.launches = 0
gather_screen_median.launches = 0
gather_dequant_screen_trimmed_mean.launches = 0
gather_dequant_screen_median.launches = 0
