"""Public entry points of the kernels, named like `repro.kernels.ops`.
Each runs under a ``torch.profiler.record_function`` range
(``kernels.<name>``), the counterpart of the reference's
``jax.named_scope``, so a profiler trace attributes the time to the rule.

Where the reference takes pre-gathered ``[E?, n, d]`` values, these take the
main path's operands: the shared broadcast ``w [M, d]`` (or, for the
codeword screens, the broadcast int8 codewords ``q [M, d]`` and
``scale [M, S, 2]`` of `repro_torch.comm.codec`), the ``[M, M]``
in-neighbor mask or the ``[M, K]`` neighbor table, and ``self_vals [M, d]``.
The device of the operands picks the implementation: the CUDA kernel on a
card, its plain PyTorch version on the CPU.

The views screens (`views_trimmed_mean`, `views_median`) take the
reference kernels' own form: each node's views ``[M, W, d]`` (the network
runtime's mailboxes) under ``mask [M, W]``.

The float screens (`trimmed_mean`, `median`, `gather_trimmed_mean`,
`gather_median`) also take the experiment axis, ``[E, M, d]`` rows and own
values with ``b`` an int or an int32 ``[E]`` tensor, in one launch; and
`pairwise_sq_dists_batched` the distances with a batch axis (the node over
mailbox views, the experiment over a grid).

The decide forms (`trimmed_mean_decide`, `median_decide` and their gather
and views forms, `repro_torch.kernels.screen_decide`) return ``(y,
trim)``: the plain screen's output bit for bit and the per-edge trim
fractions of the reference's ``*_with_decisions`` twins over every
``stride``-th coordinate, the input of the trust layer and the trace's
forensics.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.contracts import Contract
from repro_torch.kernels import dequant as _dequant
from repro_torch.kernels import dequant_screen as _dequant_screen
from repro_torch.kernels import gather_screen as _gather_screen
from repro_torch.kernels import screen_decide as _decide
from repro_torch.kernels.gather_screen import gather_screen_median, gather_screen_trimmed_mean
from repro_torch.kernels.median import median_dense
from repro_torch.kernels.pairwise import pairwise_sq_dists as _pairwise_sq_dists
from repro_torch.kernels.pairwise import pairwise_sq_dists_batched as _pairwise_batched
from repro_torch.kernels.trimmed_mean import trimmed_mean_dense
from repro_torch.kernels.views_screen import views_screen_median, views_screen_trimmed_mean


def trimmed_mean(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor, b: int,
                 recip: bool = False) -> torch.Tensor:
    with torch.profiler.record_function("kernels.trimmed_mean"):
        return trimmed_mean_dense(w, adj, self_vals, b, recip)


def median(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    with torch.profiler.record_function("kernels.median"):
        return median_dense(w, adj, self_vals)


def gather_trimmed_mean(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                        self_vals: torch.Tensor, b: int) -> torch.Tensor:
    with torch.profiler.record_function("kernels.gather_trimmed_mean"):
        return gather_screen_trimmed_mean(w, safe_idx, valid, self_vals, b)


def gather_median(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                  self_vals: torch.Tensor) -> torch.Tensor:
    with torch.profiler.record_function("kernels.gather_median"):
        return gather_screen_median(w, safe_idx, valid, self_vals)


def views_trimmed_mean(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                       b: int) -> torch.Tensor:
    with torch.profiler.record_function("kernels.views_trimmed_mean"):
        return views_screen_trimmed_mean(views, mask, self_vals, b)


def views_median(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    with torch.profiler.record_function("kernels.views_median"):
        return views_screen_median(views, mask, self_vals)


def dequant(q: torch.Tensor, scale: torch.Tensor, keep_nan: bool = False) -> torch.Tensor:
    with torch.profiler.record_function("kernels.dequant"):
        return _dequant.dequant(q, scale, keep_nan)


def dequant_carry(q: torch.Tensor, scale: torch.Tensor, est: torch.Tensor,
                  target: torch.Tensor, zero_folded: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.profiler.record_function("kernels.dequant"):
        return _dequant.dequant_carry(q, scale, est, target, zero_folded)


def dequant_trimmed_mean(q: torch.Tensor, scale: torch.Tensor, adj: torch.Tensor,
                         self_vals: torch.Tensor, b: int) -> torch.Tensor:
    """Fused decode -> trimmed mean over the int8 codewords of each node's
    in-neighbors."""
    with torch.profiler.record_function("kernels.dequant_trimmed_mean"):
        return _dequant_screen.dequant_screen_trimmed_mean_dense(q, scale, adj, self_vals, b)


def dequant_median(q: torch.Tensor, scale: torch.Tensor, adj: torch.Tensor,
                   self_vals: torch.Tensor) -> torch.Tensor:
    """Fused decode -> median over the int8 codewords of each node's
    in-neighbors (the node's own value joins uncompressed)."""
    with torch.profiler.record_function("kernels.dequant_median"):
        return _dequant_screen.dequant_screen_median_dense(q, scale, adj, self_vals)


def gather_dequant_trimmed_mean(q: torch.Tensor, scale: torch.Tensor, safe_idx: torch.Tensor,
                                valid: torch.Tensor, self_vals: torch.Tensor,
                                b: int) -> torch.Tensor:
    """Fused gather -> decode -> trimmed mean over each node's table slots."""
    with torch.profiler.record_function("kernels.gather_dequant_trimmed_mean"):
        return _gather_screen.gather_dequant_screen_trimmed_mean(q, scale, safe_idx, valid,
                                                                 self_vals, b)


def gather_dequant_median(q: torch.Tensor, scale: torch.Tensor, safe_idx: torch.Tensor,
                          valid: torch.Tensor, self_vals: torch.Tensor) -> torch.Tensor:
    """Fused gather -> decode -> median over each node's table slots and
    itself."""
    with torch.profiler.record_function("kernels.gather_dequant_median"):
        return _gather_screen.gather_dequant_screen_median(q, scale, safe_idx, valid, self_vals)


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    with torch.profiler.record_function("kernels.pairwise_sq_dists"):
        return _pairwise_sq_dists(x)


def pairwise_sq_dists_batched(x: torch.Tensor,
                              self_vals: torch.Tensor | None = None) -> torch.Tensor:
    """Distances among each batch element's rows of ``x [B, n, d]`` (at its
    strides) and, with ``self_vals [B, d]``, its own value as the last row."""
    with torch.profiler.record_function("kernels.pairwise_sq_dists_batched"):
        return _pairwise_batched(x, self_vals)


def trimmed_mean_decide(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor, b,
                        stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.profiler.record_function("kernels.trimmed_mean_decide"):
        return _decide.trimmed_mean_dense_decide(w, adj, self_vals, b, stride)


def median_decide(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor,
                  stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.profiler.record_function("kernels.median_decide"):
        return _decide.median_dense_decide(w, adj, self_vals, stride)


def gather_trimmed_mean_decide(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                               self_vals: torch.Tensor, b,
                               stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.profiler.record_function("kernels.gather_trimmed_mean_decide"):
        return _decide.gather_screen_trimmed_mean_decide(w, safe_idx, valid, self_vals, b,
                                                         stride)


def gather_median_decide(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                         self_vals: torch.Tensor,
                         stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.profiler.record_function("kernels.gather_median_decide"):
        return _decide.gather_screen_median_decide(w, safe_idx, valid, self_vals, stride)


def views_trimmed_mean_decide(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                              b, stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.profiler.record_function("kernels.views_trimmed_mean_decide"):
        return _decide.views_screen_trimmed_mean_decide(views, mask, self_vals, b, stride)


def views_median_decide(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                        stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.profiler.record_function("kernels.views_median_decide"):
        return _decide.views_screen_median_decide(views, mask, self_vals, stride)


# ---------------------------------------------------------------------------
# Contracts (`python -m repro_torch.analysis`)
# ---------------------------------------------------------------------------

CONTRACTS: tuple[Contract, ...] = (
    Contract(
        "kernels.dispatch.ref_twin", "lint",
        "every public kernel entry reaches a kernel wrapper that routes to "
        "BOTH a `ref.` twin (the CPU path) and the built library "
        "(`build.load()` or `screen_wide.launch`) — the parity surface "
        "that lets CPU CI stand in for the card",
        params=(("check", "kernel_ref_twins"), ("module", "repro_torch.kernels.ops")),
    ),
)
