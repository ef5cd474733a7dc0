"""Pairwise squared distances — the wrapper of the CUDA kernel
``pairwise_sq_dists`` (``csrc/pairwise.cu``), which replaces the TPU kernel
`repro.kernels.krum.pairwise_sq_dists_pallas`: the distance matrix of
BRIDGE-K (Krum) and BRIDGE-B (Bulyan).

A CPU tensor goes to the plain version (`ref.pairwise_sq_dists`); a CUDA
tensor launches the kernel or raises.  ``pairwise_sq_dists.launches``
counts calls that launched the kernel and nothing else.

The kernel cuts the output into upper-triangle tiles of ``8 R`` rows and
the coordinates into ``4 C`` splits: each split of a tile is a unit of 64
threads, four units share a block (one block an SM) and ``C`` blocks form
a thread-block cluster, which adds the splits' partial Grams in ascending
order through distributed shared memory.  `split_plan` picks ``R`` and
``C`` from the shape alone, so the summation order of a given ``[n, d]``
is fixed.

`pairwise_sq_dists_batched` adds a leading batch axis, ``[B, n, d] ->
[B, n, n]``, each element's rows read at the operand's own strides (a batch
stride of 0 reads one set of rows for every element, in place) and,
optionally, each element's own value appended as its last row: the
per-node distances of Krum and Bulyan over mailbox views (``[M, W, d]``
and the nodes' own values, B = M) and the grid's per-cell distances
(``[E, M, d]``, B = E).  It runs on one of two bodies, which `batch_plan`
picks from ``[B, n, d]``: the *cluster body* (the kernel above, a cluster
an element and tile pair, elements on gridDim.z) or the *batch body* (a
block of four warps an element of at most 17 rows, no cluster, a lane a
split), so that many small elements fill the card.  Both run every
element under ``split_plan(n, d)``'s order, so each element equals
`pairwise_sq_dists` of its rows bit for bit, whatever B and whichever
body.  ``cluster_body.launches`` and ``batch_body.launches`` count each
body's launches.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref

CHUNK = 32  # coordinates per ring stage (csrc/pairwise.cu kChunk); a split is a multiple
STAGES = 3  # ring depth (kStages)
PITCH = CHUNK + 4  # floats per staged row (kPitch)
UNITS = 4  # units of 64 threads (splits of one tile) a block (kUnits)
ROWS_PER_THREAD = (4, 6, 8)  # R: a unit's tile is 8R x 8R
MAX_CLUSTER = 8  # C: blocks of a cluster, the portable limit
MAX_ROWS = 32 * 1024
MAX_COORDS = 2**31 - 2**16  # the kernel's coordinate offsets are 32-bit
SMEM_PER_BLOCK = 227 * 1024  # a block's shared-memory limit on an H100
MIN_SMEM = 120 * 1024  # what a block asks for at least: one block an SM (kMinSmemBytes)

# The plan's model of an H100 SXM: its 132 SMs in GPCs (a cluster's blocks
# share a GPC, one block an SM), and the device time of one 32-coordinate
# chunk of the main loop with four units on an SM, by R (microseconds:
# `kernel_times.py --sweep`, NVIDIA H100 80GB HBM3, 700 W), which grows
# less than R^2: larger tiles issue fewer loads per FMA.
GPC_SMS = (18, 18, 16, 16, 16, 16, 16, 16)
CHUNK_US = {4: 1.28, 6: 2.57, 8: 3.99}


@dataclass(frozen=True)
class Plan:
    """How the kernel cuts an ``[n, d]`` problem."""

    rows_per_thread: int  # R
    cluster: int  # C
    split_len: int  # coordinates a split (a multiple of CHUNK)

    @property
    def tile(self) -> int:
        return 8 * self.rows_per_thread

    @property
    def splits(self) -> int:
        return UNITS * self.cluster


def _check_shape(n: int, d: int) -> None:
    if not (1 <= n <= MAX_ROWS and 1 <= d <= MAX_COORDS):
        raise ValueError(f"pairwise_sq_dists kernel takes 1 <= n <= {MAX_ROWS} rows and "
                         f"1 <= d <= {MAX_COORDS} coordinates, got [{n}, {d}]")


def canonical_split_len(d: int, splits: int) -> int:
    """The split length of ``splits`` splits over d: ceil(d / splits)
    rounded up to a whole stage (trailing splits may then be empty, and add
    +0 to the Gram)."""
    return -(-(-(-d // splits)) // CHUNK) * CHUNK


def smem_bytes(plan: Plan) -> int:
    """Dynamic shared memory of a block (csrc/pairwise.cu ``launch``)."""
    t = plan.tile
    unit = max(STAGES * 2 * t * PITCH, t * (t + 1)) + 2 * t
    stripe = -(-t // plan.cluster)
    return max(MIN_SMEM, 4 * (UNITS * unit + stripe * t + stripe + t))


def check_plan(plan: Plan, n: int, d: int) -> None:
    """Raise unless ``plan`` is one the kernel takes for ``[n, d]``: R and C
    within their limits, the canonical split length, and a block within
    the card's shared memory."""
    _check_shape(n, d)
    if plan.rows_per_thread not in ROWS_PER_THREAD or not 1 <= plan.cluster <= MAX_CLUSTER:
        raise ValueError(f"pairwise plan outside the kernel's limits: {plan}")
    if plan.split_len != canonical_split_len(d, plan.splits):
        raise ValueError(f"pairwise plan {plan}: split length for d = {d} over {plan.splits} "
                         f"splits must be {canonical_split_len(d, plan.splits)}")
    if smem_bytes(plan) > SMEM_PER_BLOCK:
        raise ValueError(f"pairwise plan {plan} needs {smem_bytes(plan)} bytes of shared memory")


def candidates(n: int, d: int) -> list[Plan]:
    """Every plan the kernel takes for ``[n, d]``, in a fixed order."""
    _check_shape(n, d)
    out = []
    for r in ROWS_PER_THREAD:
        for c in range(1, MAX_CLUSTER + 1):
            plan = Plan(r, c, canonical_split_len(d, UNITS * c))
            if smem_bytes(plan) <= SMEM_PER_BLOCK:
                out.append(plan)
    return out


def waves(plan: Plan, n: int) -> int:
    """Rounds of clusters the card runs the plan's tiles in: a GPC holds
    ``floor(SMs / C)`` clusters at once."""
    tiles = -(-n // plan.tile)
    at_once = sum(sms // plan.cluster for sms in GPC_SMS)
    return -(-(tiles * (tiles + 1) // 2) // at_once)


def cost(plan: Plan, n: int) -> float:
    """The model's device time of the main loop (microseconds): waves of
    clusters, each as long as one unit's chunks."""
    return waves(plan, n) * -(-plan.split_len // CHUNK) * CHUNK_US[plan.rows_per_thread]


@functools.cache
def split_plan(n: int, d: int) -> Plan:
    """The plan for ``[n, d]``: the cheapest of `candidates` by `cost`
    (ties to the first: the smaller tile, then the smaller cluster), a
    function of the shape alone."""
    return min(candidates(n, d), key=lambda p: cost(p, n))


def pairwise_sq_dists(x: torch.Tensor, plan: Plan | None = None) -> torch.Tensor:
    """``[n, n]`` float32 squared distances between the rows of the float32
    contiguous ``x [n, d]``: symmetric bit for bit, an exact zero diagonal
    for finite rows, NaN kept.  ``plan`` overrides `split_plan` (a kernel
    sweep's knob; the summation order then follows it)."""
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
    if plan is None:
        plan = split_plan(n, d)
    else:
        check_plan(plan, n, d)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    err = build.load().pairwise_sq_dists(x.data_ptr(), out.data_ptr(), n, d, plan.rows_per_thread,
                                         plan.cluster, plan.split_len, build.stream_of(x))
    build.check_launch(err, "pairwise_sq_dists")
    pairwise_sq_dists.launches += 1
    return out


pairwise_sq_dists.launches = 0

MAX_BATCH = 2**31 - 1

# The batch body (csrc/pairwise.cu pairwise_batch_kernel): a block of four
# warps an element of at most ONE_TILE rows, a lane a split, a ring of
# three stages of 16 coordinates of every split.
ONE_TILE = 17
BATCH_SMEM = 4 * 3 * 16 * 32 * ONE_TILE  # a block's ring (kBatchStages x kStageFloats floats)
# batch_plan's model of the two bodies on an H100 SXM, fitted to
# `kernel_times.py --sweep` (NVIDIA H100 80GB HBM3, 700 W): a launch's fixed
# cost; a wave of clusters, a fixed part and a part per 256 coordinates of
# a split; the batch body's time a stage of a block (on a card its blocks
# do not fill) and the rate its reads of the rows reach on a full card.
LAUNCH_US = 5.0
CLUSTER_WAVE_US = (6.0, 12.0)
BATCH_STAGE_US = 4.8
BATCH_BYTES_PER_US = 1.38e6


@dataclass(frozen=True)
class BatchPlan:
    """How the batched kernel runs ``[B, n, d]``: every element under
    ``order`` (``split_plan(n, d)``: the summation order, and the cluster
    body's geometry), on ``body``: "cluster" or "batch" (the batch body,
    n <= ONE_TILE)."""

    order: Plan
    body: str = "cluster"


def _check_batch_shape(bsz: int, n: int, d: int) -> None:
    _check_shape(n, d)
    if not 1 <= bsz <= MAX_BATCH:
        raise ValueError(f"pairwise_sq_dists_batched takes 1 to {MAX_BATCH} elements, got {bsz}")


def batch_candidates(bsz: int, n: int, d: int) -> list[BatchPlan]:
    """Every plan of ``[B, n, d]`` in a fixed order: the cluster body, then
    the batch body where n <= ONE_TILE."""
    _check_batch_shape(bsz, n, d)
    order = split_plan(n, d)
    return [BatchPlan(order)] + ([BatchPlan(order, "batch")] if n <= ONE_TILE else [])


def check_batch_plan(plan: BatchPlan, bsz: int, n: int, d: int) -> None:
    """Raise unless ``plan`` is one of `batch_candidates` of the shape."""
    if plan not in batch_candidates(bsz, n, d):
        raise ValueError(f"batched pairwise plan {plan} is not one the kernel takes for "
                         f"[{bsz}, {n}, {d}] (order {split_plan(n, d)})")


def tile_pairs(tile: int, n: int) -> int:
    """Upper-triangle tile pairs of ``n`` rows in tiles of ``tile``."""
    tiles = -(-n // tile)
    return tiles * (tiles + 1) // 2


def batch_cost(plan: BatchPlan, bsz: int, n: int, d: int) -> float:
    """The model's device time of a plan (microseconds).  Cluster body:
    waves of clusters (a GPC holds floor(SMs / C) at once).  Batch body:
    the longer of one block's chain of stages and the element rows' bytes
    at the rate its copies reach."""
    order = plan.order
    if plan.body == "batch":
        stages = order.split_len // 16
        nbytes = bsz * n * d * 4
        return LAUNCH_US + max(stages * BATCH_STAGE_US, nbytes / BATCH_BYTES_PER_US)
    at_once = sum(sms // order.cluster for sms in GPC_SMS)
    wave = CLUSTER_WAVE_US[0] + CLUSTER_WAVE_US[1] * order.split_len / 256
    return LAUNCH_US + -(-bsz * tile_pairs(order.tile, n) // at_once) * wave


@functools.cache
def batch_plan(bsz: int, n: int, d: int) -> BatchPlan:
    """The plan for ``[B, n, d]``: the cheapest of `batch_candidates` by
    `batch_cost` (ties to the first: the cluster body), a function of the
    shape alone.  Every candidate runs ``split_plan(n, d)``'s order, so the
    choice changes no bit."""
    return min(batch_candidates(bsz, n, d), key=lambda p: batch_cost(p, bsz, n, d))


def _check_batched(x: torch.Tensor, self_vals: torch.Tensor | None) -> None:
    if x.dtype != torch.float32 or (self_vals is not None and self_vals.dtype != torch.float32):
        raise TypeError("pairwise_sq_dists_batched takes float32 operands")
    if x.ndim != 3 or min(x.shape) < 1:
        raise ValueError(f"pairwise_sq_dists_batched takes a non-empty [B, n, d], "
                         f"got {tuple(x.shape)}")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError("pairwise_sq_dists_batched rows must have a unit coordinate stride")
    if self_vals is not None:
        if self_vals.shape != (x.shape[0], x.shape[2]):
            raise ValueError(f"self_vals {tuple(self_vals.shape)} must be [B, d] of x "
                             f"{tuple(x.shape)}")
        if x.shape[2] > 1 and self_vals.stride(1) != 1:
            raise ValueError("self_vals must have a unit coordinate stride")
        if self_vals.device != x.device:
            raise ValueError(f"operands on different devices: {x.device}, {self_vals.device}")


def _operands(x: torch.Tensor, self_vals: torch.Tensor | None, out: torch.Tensor) -> tuple:
    """The entry points' leading operands: x and its batch and row strides,
    self_vals (or null) and its stride, out."""
    self_ptr, s_self = (None, 0) if self_vals is None else (self_vals.data_ptr(),
                                                            self_vals.stride(0))
    return x.data_ptr(), x.stride(0), x.stride(1), self_ptr, s_self, out.data_ptr()


def cluster_body(x: torch.Tensor, self_vals: torch.Tensor | None, out: torch.Tensor,
                 plan: BatchPlan) -> None:
    """Launch the cluster body into ``out [B, n, n]``; counts its launches."""
    bsz, n, d = out.shape[0], out.shape[1], x.shape[2]
    order = plan.order
    err = build.load().pairwise_sq_dists_batched(
        *_operands(x, self_vals, out), bsz, n, d, order.rows_per_thread, order.cluster,
        order.split_len, build.stream_of(x))
    build.check_launch(err, "pairwise_sq_dists_batched")
    cluster_body.launches += 1


def batch_body(x: torch.Tensor, self_vals: torch.Tensor | None, out: torch.Tensor,
               plan: BatchPlan) -> None:
    """Launch the batch body into ``out [B, n, n]``; counts its launches."""
    bsz, n, d = out.shape[0], out.shape[1], x.shape[2]
    order = plan.order
    err = build.load().pairwise_sq_dists_batch_body(
        *_operands(x, self_vals, out), bsz, n, d, order.splits, order.split_len,
        build.stream_of(x))
    build.check_launch(err, "pairwise_sq_dists_batch_body")
    batch_body.launches += 1


cluster_body.launches = 0
batch_body.launches = 0


def pairwise_sq_dists_batched(x: torch.Tensor, self_vals: torch.Tensor | None = None,
                              plan: BatchPlan | None = None) -> torch.Tensor:
    """``[B, n, n]`` float32 squared distances among each batch element's
    rows: ``x [B, n_x, d]`` at its strides (the batch stride may be 0), and
    with ``self_vals [B, d]`` element b's own value as row ``n = n_x + 1``'s
    last; each element as `pairwise_sq_dists` of those rows computes it, bit
    for bit, on the body ``batch_plan(B, n, d)`` (or ``plan``, one of
    `batch_candidates`) picks."""
    _check_batched(x, self_vals)
    if x.device.type == "cpu":
        return ref.pairwise_sq_dists_batched(x, self_vals)
    if x.device.type != "cuda":
        raise ValueError(f"no pairwise_sq_dists kernel for device {x.device}")
    bsz, nx, d = x.shape
    n = nx + (self_vals is not None)
    if plan is None:
        plan = batch_plan(bsz, n, d)
    else:
        check_batch_plan(plan, bsz, n, d)
    out = torch.empty((bsz, n, n), dtype=torch.float32, device=x.device)
    (batch_body if plan.body == "batch" else cluster_body)(x, self_vals, out, plan)
    return out
