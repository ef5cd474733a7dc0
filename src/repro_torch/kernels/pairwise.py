"""Pairwise squared distances — the wrapper of the CUDA kernel
``pairwise_sq_dists`` (``csrc/pairwise.cu``), which replaces the TPU kernel
`repro.kernels.krum.pairwise_sq_dists_pallas`: the distance matrix of
BRIDGE-K (Krum) and BRIDGE-B (Bulyan).

A CPU tensor goes to the plain version (`ref.pairwise_sq_dists`); a CUDA
tensor launches the kernel or raises.  ``pairwise_sq_dists.launches``
counts calls that launched the kernel (its two launches, the split Gram
and the epilogue, count once) and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

# Split plan of the coordinate axis: at most TARGET_BLOCKS (tile, split)
# blocks, two per SM of an H100, so no SM holds more than two equal
# blocks, but no split shorter than MIN_SPLIT coordinates.  A function of
# the shape alone, so the summation order of a given [n, d] is fixed.
TARGET_BLOCKS = 264
MIN_SPLIT = 256
CHUNK = 32  # coordinates per shared-memory stage (csrc/pairwise.cu kChunk)
TILE = 64  # output tile edge (csrc/pairwise.cu kTile)
MAX_ROWS = 32 * 1024


def split_plan(n: int, d: int) -> tuple[int, int]:
    """``(split_len, splits)``: the coordinate axis cut into ``splits``
    runs of ``split_len`` (a multiple of the 32-coordinate stage), the last
    one short."""
    tiles = -(-n // TILE)
    pairs = tiles * (tiles + 1) // 2
    want = max(1, min(TARGET_BLOCKS // pairs, -(-d // MIN_SPLIT)))
    split_len = -(-(-(-d // want)) // CHUNK) * CHUNK
    return split_len, -(-d // split_len)


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """``[n, n]`` float32 squared distances between the rows of the float32
    contiguous ``x [n, d]``: symmetric bit for bit, an exact zero diagonal
    for finite rows, NaN kept."""
    if x.dtype != torch.float32:
        raise TypeError(f"pairwise_sq_dists takes float32, got {x.dtype}")
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"pairwise_sq_dists takes a non-empty [n, d], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("pairwise_sq_dists operand must be contiguous")
    if x.device.type == "cpu":
        return ref.pairwise_sq_dists(x)
    if x.device.type != "cuda":
        raise ValueError(f"no pairwise_sq_dists kernel for device {x.device}")
    n, d = x.shape
    if n > MAX_ROWS:
        raise ValueError(f"pairwise_sq_dists kernel takes at most {MAX_ROWS} rows, got {n}")
    split_len, splits = split_plan(n, d)
    part = torch.empty((splits, n, n), dtype=torch.float32, device=x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    err = build.load().pairwise_sq_dists(x.data_ptr(), part.data_ptr(), out.data_ptr(), n, d,
                                         split_len, splits, build.stream_of(x))
    build.check_launch(err, "pairwise_sq_dists")
    pairwise_sq_dists.launches += 1
    return out


pairwise_sq_dists.launches = 0
