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
tensor launches a kernel or raises: the tile kernel up to `MAX_SLOTS`
slots, under the plan `tile_plan` picks from the shape, and the wide path
(`screen_wide`) above.  Each wrapper's ``launches`` counts its tile
kernel's launches and nothing else; ``screen_wide.launch.launches`` the
wide path's.

The tile kernel gives a block of 256 threads ``tile`` consecutive nodes
and a range of coordinate chunks of ``chunk``; its warps read the nodes'
columns straight from L2 and sort them in registers.  `tile_plan` picks
the plan from the shape; `block_work` is the kernel's own split of its
grid.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.fence import fence
from repro_torch.kernels import build, ref, screen_wide
from repro_torch.kernels.dequant import check_codeword_rows

# Table slots the tile kernel takes: it sorts K rows (K + 1 for the median)
# in a register network of at most 64, the reference's sequential-sum bound.
MAX_SLOTS = 63
THREADS = 256  # a tile block (csrc/gather_screen.cu kTileThreads)
MAX_TILE_SLOTS = THREADS  # tile * K: one slot a thread in the prologue
MAX_TILE_NODES = 32
CHUNKS = (32, 64, 128)  # coordinates a chunk: divisors of the codec's 128-coordinate scale block
# The card: an H100 SXM's SMs, and the tile blocks one holds at once (the
# main path's kernels use 56-74 registers a thread, which allow three or
# four; the plan asks for four).
SMS = 132
BLOCKS_PER_SM = 4


@dataclass(frozen=True)
class TilePlan:
    """How the tile kernel cuts an ``[M, K]`` table over ``d``
    coordinates."""

    tile: int  # consecutive nodes a block
    chunk: int  # coordinates a block takes at a time
    segments: int  # chunk ranges a tile is cut into (blocks a tile)
    cols: int = 1  # columns a lane sorts at once (coordinates 32 apart)

    def grid(self, m: int) -> int:
        return -(-m // self.tile) * self.segments


def _check_shape(m: int, k: int, d: int, row_bytes: int) -> None:
    if not (m >= 1 and d >= 1 and 0 <= k <= MAX_SLOTS and row_bytes in (1, 4)):
        raise ValueError(f"the gather tile kernel takes M >= 1, d >= 1, 0 <= K <= {MAX_SLOTS} and "
                         f"4-byte (float) or 1-byte (code) rows, got M={m}, K={k}, d={d}, "
                         f"row_bytes={row_bytes}")


def _cols_fit(cols: int, k: int, row_bytes: int, median: bool) -> bool:
    """Two columns a lane are compiled for the float median of at most 32
    rows only (where the sweep found them faster, `kernel_times.py
    --sweep-gather`; two columns of 64 rows would spill)."""
    return cols == 1 or (cols == 2 and median and row_bytes == 4 and k + 1 <= 32)


def _fits(tile: int, chunk: int, cols: int, k: int, row_bytes: int, median: bool) -> bool:
    return (1 <= tile <= MAX_TILE_NODES and tile * k <= MAX_TILE_SLOTS and chunk in CHUNKS
            and _cols_fit(cols, k, row_bytes, median) and chunk >= 32 * cols)


def check_tile_plan(plan: TilePlan, m: int, k: int, d: int, row_bytes: int,
                    median: bool = False) -> None:
    """Raise unless the tile kernel takes ``plan`` for this shape and rule."""
    _check_shape(m, k, d, row_bytes)
    if not (_fits(plan.tile, plan.chunk, plan.cols, k, row_bytes, median)
            and 1 <= plan.segments <= -(-d // plan.chunk)):
        raise ValueError(f"gather tile plan outside the kernel's limits for M={m}, K={k}, d={d} "
                         f"({'median' if median else 'trimmed mean'}, {row_bytes}-byte rows): "
                         f"{plan}")


def plan_for(tile: int, chunk: int, m: int, k: int, d: int, row_bytes: int,
             median: bool = False, cols: int = 1) -> TilePlan | None:
    """The plan of this tile, chunk and columns a lane, its tiles cut into
    as many chunk ranges as fill one wave of the card; None where the
    kernel cannot take it."""
    if not _fits(tile, chunk, cols, k, row_bytes, median):
        return None
    per_tile = max(1, SMS * BLOCKS_PER_SM // -(-m // tile))
    return TilePlan(tile, chunk, min(per_tile, -(-d // chunk)), cols)


def candidates(m: int, k: int, d: int, row_bytes: int, median: bool = False) -> list[TilePlan]:
    """The tile kernel's plans, in their order of preference: tiles of 4, 8
    and 16 nodes, chunks of 128 and 64 coordinates, 4 x 128 first for float
    rows and 16 x 64 for codeword rows, whose staged scale pairs then serve
    16 nodes (the fastest of each on the main path's tables,
    `kernel_times.py --sweep-gather`).  Two columns a lane for the float
    median up to K = 16, one otherwise (at K = 20 two arrays of 24 rows
    lose to one)."""
    _check_shape(m, k, d, row_bytes)
    cols = 2 if _cols_fit(2, k, row_bytes, median) and k <= 16 else 1
    shapes = [(4, 128), (4, 64), (8, 128), (8, 64), (16, 128), (16, 64)]
    if row_bytes == 1:
        shapes.insert(0, shapes.pop())
    plans = (plan_for(tile, chunk, m, k, d, row_bytes, median, cols) for tile, chunk in shapes)
    return [p for p in plans if p is not None]


def block_work(plan: TilePlan, m: int, d: int, block: int) -> tuple[range, range]:
    """The nodes and the coordinate chunks block ``block`` of the plan's
    grid screens (the tile kernel's own split): tile ``block // segments``,
    and the ``block % segments``-th of the tile's near-equal chunk ranges."""
    tile, seg = divmod(block, plan.segments)
    chunks = -(-d // plan.chunk)
    return (range(tile * plan.tile, min((tile + 1) * plan.tile, m)),
            range(seg * chunks // plan.segments, (seg + 1) * chunks // plan.segments))


@functools.cache
def tile_plan(m: int, k: int, d: int, row_bytes: int, median: bool = False) -> TilePlan:
    """The tile kernel's plan for an ``[M, K]`` table over ``d``
    coordinates of ``row_bytes``-byte rows, for the median or the trimmed
    mean: the first of `candidates`, a function of the shape alone."""
    return candidates(m, k, d, row_bytes, median)[0]


def check_gather_args(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                      self_vals: torch.Tensor) -> None:
    """Validate the sparse screening operands: `build.check_rows`, a
    contiguous int32 ``[M, K]`` index table and a bool/uint8 mask of its
    shape (or ``[E, M, K]``, one an experiment), all on one device."""
    build.check_rows(w, self_vals)
    if safe_idx.dtype != torch.int32:
        raise TypeError(f"safe_idx must be int32, got {safe_idx.dtype}")
    if safe_idx.ndim != 2 or safe_idx.shape[0] != w.shape[-2]:
        raise ValueError(f"safe_idx {tuple(safe_idx.shape)} must be [M={w.shape[-2]}, K]")
    if not safe_idx.is_contiguous():
        raise ValueError("neighbor table operands must be contiguous")
    if w.device != safe_idx.device:
        raise ValueError(f"operands on different devices: {w.device}, {safe_idx.device}")
    build.check_mask(valid, w, tuple(safe_idx.shape), "valid")


def _head(rows: tuple, safe_idx: torch.Tensor, valid: torch.Tensor, self_vals: torch.Tensor,
          out: torch.Tensor, b) -> tuple:
    """An entry point's operands ahead of the plan: the row source (w, or
    q and scale), the table, self_vals and out, then M, K, d, the
    codewords' scale blocks and the trimmed mean's b; for float rows the
    experiment operands (`build.experiments`) in place of the scalar b."""
    m, d = self_vals.shape[-2:]
    if len(rows) == 2:
        tail = (rows[1].shape[1], *(() if b is None else (int(b),)))
    else:
        tail = build.experiments(self_vals, valid, b)
    return (*(t.data_ptr() for t in (*rows, safe_idx, valid, self_vals, out)), m,
            safe_idx.shape[1], d, *tail)


def _launch_plan(name: str, plan: TilePlan, head: tuple, stream: int) -> None:
    err = getattr(build.load(), name)(*head, plan.tile, plan.chunk, plan.segments, plan.cols,
                                      stream)
    build.check_launch(err, name)


def launch_tile(name: str, plan: TilePlan, rows: tuple, safe_idx: torch.Tensor,
                valid: torch.Tensor, self_vals: torch.Tensor, b: int | None = None
                ) -> torch.Tensor:
    """``name``'s tile kernel under ``plan`` on CUDA operands the wrapper
    has checked (``rows`` is ``(w,)`` or ``(q, scale)``; ``b`` for the
    trimmed mean); returns the output.  Counts nothing: the wrappers count
    their launches under `tile_plan`'s plan, and the card tests and
    `kernel_times.py --sweep-gather` hold other plans with it."""
    out = torch.empty_like(self_vals)
    _launch_plan(name, plan, _head(rows, safe_idx, valid, self_vals, out, b),
                 build.stream_of(self_vals))
    return out


def dispatch(name: str, head: tuple, m: int, k: int, d: int, row_bytes: int, median: bool,
             stream: int) -> bool:
    """Launch ``name``'s tile kernel under `tile_plan`'s plan, or its wide
    twin above `MAX_SLOTS` slots, on ``head`` (the entry point's operands
    ahead of the plan: pointers, then sizes); returns whether the tile
    kernel ran.  The gather and the views screens share it."""
    if k > MAX_SLOTS:
        screen_wide.launch(name.replace("screen_", "screen_wide_", 1), k + int(median), *head,
                           stream)
        return False
    _launch_plan(name, tile_plan(m, k, d, row_bytes, median), head, stream)
    return True


def _screen(name: str, rows: tuple, safe_idx: torch.Tensor, valid: torch.Tensor,
            self_vals: torch.Tensor, b: int | None) -> tuple[torch.Tensor, bool]:
    """``name``'s kernel through `dispatch` (``b`` None: the median);
    returns the output and whether the tile kernel ran."""
    if self_vals.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {self_vals.device}")
    (m, d), k = self_vals.shape[-2:], safe_idx.shape[1]
    out = torch.empty_like(self_vals)
    tiled = dispatch(name, _head(rows, safe_idx, valid, self_vals, out, b), m, k, d,
                     4 if len(rows) == 1 else 1, b is None, build.stream_of(self_vals))
    return out, tiled


def gather_screen_trimmed_mean(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                               self_vals: torch.Tensor, b) -> torch.Tensor:
    """Trimmed-mean screening of every node over its table slots; returns
    ``[M, d]`` float32 (the experiment axis: ``w`` and ``self_vals``
    ``[E, M, d]``, ``b`` an int or an int32 ``[E]`` tensor, one launch)."""
    check_gather_args(w, safe_idx, valid, self_vals)
    build.check_b(b, w)
    if w.device.type == "cpu":
        return ref.gather_trimmed_mean(w, safe_idx, valid, self_vals, b)
    out, tiled = _screen("gather_screen_trimmed_mean", (w,), safe_idx, valid, self_vals, b)
    gather_screen_trimmed_mean.launches += tiled
    return out


def gather_screen_median(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                         self_vals: torch.Tensor) -> torch.Tensor:
    """Median screening of every node over its table slots and itself;
    returns ``[M, d]`` float32 (``[E, M, d]`` over the experiment axis)."""
    check_gather_args(w, safe_idx, valid, self_vals)
    if w.device.type == "cpu":
        return ref.gather_median(w, safe_idx, valid, self_vals)
    out, tiled = _screen("gather_screen_median", (w,), safe_idx, valid, self_vals, None)
    gather_screen_median.launches += tiled
    return fence(out, "kernels.median")


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
    out, tiled = _screen("gather_dequant_screen_trimmed_mean", (q, scale), safe_idx, valid,
                         self_vals, b)
    gather_dequant_screen_trimmed_mean.launches += tiled
    return out


def gather_dequant_screen_median(q: torch.Tensor, scale: torch.Tensor, safe_idx: torch.Tensor,
                                 valid: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """Median screening of every node over its table slots' decoded
    codewords and itself; returns ``[M, d]`` float32."""
    check_gather_codeword(q, scale, safe_idx, valid, self_vals)
    if q.device.type == "cpu":
        return ref.gather_dequant_median(q, scale, safe_idx, valid, self_vals)
    out, tiled = _screen("gather_dequant_screen_median", (q, scale), safe_idx, valid, self_vals,
                         None)
    gather_dequant_screen_median.launches += tiled
    return fence(out, "kernels.median")


gather_screen_trimmed_mean.launches = 0
gather_screen_median.launches = 0
gather_dequant_screen_trimmed_mean.launches = 0
gather_dequant_screen_median.launches = 0
