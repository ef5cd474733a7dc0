"""The decide form of the screening kernels — the wrappers of
``csrc/screen_decide.cu`` (dense), ``csrc/gather_screen_decide.cu``
(sparse table) and ``csrc/views_screen_decide.cu`` (mailbox views).

Each returns ``(y, trim)``: ``y`` the plain screen's output bit for bit
(the same kernel, compiled with its ``kDecide`` form) and ``trim`` the
per-edge fractions of the reference's ``*_with_decisions`` twins
(`repro.core.screening`): for every node and every row it lists, the
fraction of the columns ``0, s, 2s, ..`` (``s = stride``) on which the
row's value fell outside the kept window, 0 for rows it does not list.
``trim`` is ``[.., M, M]`` (receiver by sender) on the dense layout and
``[.., M, K]`` (by table or view slot) on the sparse ones.  The kernels
count into int32 with integer atomics; `ref.count_fraction` turns the
counts into the reference's fractions.

A CPU tensor goes to the plain version (`ref.trimmed_mean_dense_decide`
and its siblings); a CUDA tensor launches a kernel or raises: the register
kernels up to `networks.MAX_ROWS` rows to sort dense and
`gather_screen.MAX_SLOTS` slots sparse, the wide path's decide form
(``csrc/screen_wide.cuh``, `screen_wide.launch_decide`) above, as the plain
entries route to `screen_wide`; never a plain sort.  Each wrapper's
``launches`` counts its register kernel's launches and nothing else;
``screen_wide.launch_decide.launches`` the wide decide form's.

Masks a cell (``[E, M, M]`` adjacency, ``[E, M, K]`` table or view masks:
the trust layer's evictions) go through the kernels' experiment operands.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, gather_screen, networks, ref, screen_wide
from repro_torch.kernels.views_screen import check_views_args


def _check_stride(stride: int) -> None:
    if int(stride) < 1:
        raise ValueError(f"decide_stride must be >= 1, got {stride}")


def _finish(counts: torch.Tensor, d: int, stride: int) -> torch.Tensor:
    return ref.count_fraction(counts, -(-d // stride))


def _cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")


def _wide(name: str) -> str:
    """The wide decide entry of a register decide entry's ``name``."""
    return name.replace("screen_", "screen_wide_", 1)


def _dense(fn, name: str, w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor, b,
           stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``name`` (or its wide form above the register networks);
    ``fn.launches`` counts the register launches."""
    _cuda(w, name)
    m, d = w.shape[-2:]
    rows = m + (b is None)
    out = torch.empty_like(w)
    counts = torch.zeros((*w.shape[:-1], m), dtype=torch.int32, device=w.device)
    exps = build.experiments(w, adj) if b is None else build.experiments(w, adj, b)
    args = (w.data_ptr(), adj.data_ptr(), self_vals.data_ptr(), out.data_ptr(),
            counts.data_ptr(), m, d, *exps, int(stride), build.stream_of(w))
    if rows > networks.MAX_ROWS:
        screen_wide.launch_decide(_wide(name), rows, *args)
    else:
        err = getattr(build.load(), name)(*args)
        build.check_launch(err, name)
        fn.launches += 1
    return out, _finish(counts, d, stride)


def trimmed_mean_dense_decide(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor, b,
                              stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`trimmed_mean.trimmed_mean_dense` with its decisions: ``(y [.., M,
    d], trim [.., M, M])``."""
    build.check_screen_args(w, adj, self_vals)
    build.check_b(b, w)
    _check_stride(stride)
    if w.device.type == "cpu":
        return ref.trimmed_mean_dense_decide(w, adj, self_vals, b, stride)
    return _dense(trimmed_mean_dense_decide, "screen_trimmed_mean_dense_decide", w, adj,
                  self_vals, b, stride)


def median_dense_decide(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor,
                        stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`median.median_dense` with its decisions: ``(y [.., M, d], trim
    [.., M, M])``."""
    build.check_screen_args(w, adj, self_vals)
    _check_stride(stride)
    if w.device.type == "cpu":
        return ref.median_dense_decide(w, adj, self_vals, stride)
    return _dense(median_dense_decide, "screen_median_dense_decide", w, adj, self_vals, None,
                  stride)


def _plan(m: int, k: int, d: int) -> gather_screen.TilePlan:
    """The decide form's plan: the float trimmed mean's (one column a lane,
    whatever the rule)."""
    return gather_screen.tile_plan(m, k, d, 4, False)


def _tiled(fn, name: str, head: tuple, tail: tuple, m: int, k: int, d: int, stream: int) -> None:
    """Launch the tile entry ``name`` under its plan up to
    `gather_screen.MAX_SLOTS` slots, its wide form above (no plan);
    ``fn.launches`` counts the tile launches."""
    if k > gather_screen.MAX_SLOTS:
        rows = k + name.endswith("median_decide")
        screen_wide.launch_decide(_wide(name), rows, *head, *tail, stream)
        return
    plan = _plan(m, k, d)
    err = getattr(build.load(), name)(*head, *tail, plan.tile, plan.chunk, plan.segments, stream)
    build.check_launch(err, name)
    fn.launches += 1


def _experiment_tail(self_vals: torch.Tensor, mask: torch.Tensor, b, stride: int) -> tuple:
    """The experiment operands (`build.experiments`, with the scalar b
    ahead for the trimmed mean) and the stride."""
    return (*build.experiments(self_vals, mask, b), int(stride))


def gather_screen_trimmed_mean_decide(w: torch.Tensor, safe_idx: torch.Tensor,
                                      valid: torch.Tensor, self_vals: torch.Tensor, b,
                                      stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`gather_screen.gather_screen_trimmed_mean` with its decisions:
    ``(y [.., M, d], trim [.., M, K])`` by table slot."""
    gather_screen.check_gather_args(w, safe_idx, valid, self_vals)
    build.check_b(b, w)
    _check_stride(stride)
    if w.device.type == "cpu":
        return ref.gather_trimmed_mean_decide(w, safe_idx, valid, self_vals, b, stride)
    _cuda(w, "gather_screen_trimmed_mean_decide")
    (m, d), k = w.shape[-2:], safe_idx.shape[1]
    out = torch.empty_like(self_vals)
    counts = torch.zeros((*w.shape[:-1], k), dtype=torch.int32, device=w.device)
    head = (w.data_ptr(), safe_idx.data_ptr(), valid.data_ptr(), self_vals.data_ptr(),
            out.data_ptr(), counts.data_ptr(), m, k, d)
    _tiled(gather_screen_trimmed_mean_decide, "gather_screen_trimmed_mean_decide", head,
           _experiment_tail(self_vals, valid, b, stride), m, k, d, build.stream_of(w))
    return out, _finish(counts, d, stride)


def gather_screen_median_decide(w: torch.Tensor, safe_idx: torch.Tensor, valid: torch.Tensor,
                                self_vals: torch.Tensor,
                                stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`gather_screen.gather_screen_median` with its decisions: ``(y [..,
    M, d], trim [.., M, K])`` by table slot."""
    gather_screen.check_gather_args(w, safe_idx, valid, self_vals)
    _check_stride(stride)
    if w.device.type == "cpu":
        return ref.gather_median_decide(w, safe_idx, valid, self_vals, stride)
    _cuda(w, "gather_screen_median_decide")
    (m, d), k = w.shape[-2:], safe_idx.shape[1]
    out = torch.empty_like(self_vals)
    counts = torch.zeros((*w.shape[:-1], k), dtype=torch.int32, device=w.device)
    head = (w.data_ptr(), safe_idx.data_ptr(), valid.data_ptr(), self_vals.data_ptr(),
            out.data_ptr(), counts.data_ptr(), m, k, d)
    _tiled(gather_screen_median_decide, "gather_screen_median_decide", head,
           _experiment_tail(self_vals, valid, None, stride), m, k, d, build.stream_of(w))
    return out, _finish(counts, d, stride)


def _views(fn, name: str, views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, b,
           stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    _cuda(views, name)
    m, w, d = views.shape[-3:]
    s_exp = views.stride(0) if views.ndim == 4 else 0
    out = torch.empty_like(self_vals)
    counts = torch.zeros((*self_vals.shape[:-1], w), dtype=torch.int32, device=views.device)
    head = (views.data_ptr(), s_exp, views.stride(-3), views.stride(-2), mask.data_ptr(),
            self_vals.data_ptr(), out.data_ptr(), counts.data_ptr(), m, w, d)
    _tiled(fn, name, head, _experiment_tail(self_vals, mask, b, stride), m, w, d,
           build.stream_of(views))
    return out, _finish(counts, d, stride)


def views_screen_trimmed_mean_decide(views: torch.Tensor, mask: torch.Tensor,
                                     self_vals: torch.Tensor, b,
                                     stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`views_screen.views_screen_trimmed_mean` with its decisions: ``(y
    [.., M, d], trim [.., M, W])`` by view slot."""
    check_views_args(views, mask, self_vals)
    build.check_b(b, self_vals)
    _check_stride(stride)
    if views.device.type == "cpu":
        return ref.trimmed_mean_views_decide(views, mask, self_vals, b, stride)
    return _views(views_screen_trimmed_mean_decide, "views_screen_trimmed_mean_decide", views,
                  mask, self_vals, b, stride)


def views_screen_median_decide(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                               stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """`views_screen.views_screen_median` with its decisions: ``(y [.., M,
    d], trim [.., M, W])`` by view slot."""
    check_views_args(views, mask, self_vals)
    _check_stride(stride)
    if views.device.type == "cpu":
        return ref.median_views_decide(views, mask, self_vals, stride)
    return _views(views_screen_median_decide, "views_screen_median_decide", views, mask,
                  self_vals, None, stride)


for _fn in (trimmed_mean_dense_decide, median_dense_decide, gather_screen_trimmed_mean_decide,
            gather_screen_median_decide, views_screen_trimmed_mean_decide,
            views_screen_median_decide):
    _fn.launches = 0
