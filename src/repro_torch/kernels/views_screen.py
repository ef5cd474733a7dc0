"""Screening of the network runtime's mailbox views — the wrappers of the
CUDA kernels ``views_screen_trimmed_mean`` and ``views_screen_median``
(``csrc/views_screen.cu``), which replace the TPU kernels
`repro.kernels.trimmed_mean.trimmed_mean_pallas` and
`repro.kernels.median.median_pallas` in those kernels' own form: values
``[E, n, d]`` under ``mask [E, n]`` against ``self [E, d]``, here the views
``[M, W, d]`` each node holds under the usable mask ``[M, W]``.

The views are read at their own strides: a receiver stride of 0 (a
broadcast expanded over the receivers) or a sliced mailbox is screened in
place, never copied.

The experiment axis (the net grids' cells, `repro_torch.sim.engine`):
views ``[E, M, W, d]`` at their own cell stride, a usable mask ``[M, W]``
every cell shares or ``[E, M, W]`` (Bulyan's selections, the grids'
per-cell mailboxes), ``self_vals [E, M, d]`` and, for the trimmed mean,
``b`` an int or an int32 ``[E]`` tensor: one launch screens every cell,
each cell's output its own ``[M, W, d]`` call's bit for bit.

A CPU tensor goes to the plain version
(`ref.trimmed_mean_views`, `ref.median_views`); a CUDA tensor launches a
kernel or raises: the gather screens' tile kernel up to
`gather_screen.MAX_SLOTS` slots, under `gather_screen.tile_plan`'s plan for
float rows, and the wide path (`screen_wide`) above.  Each wrapper's
``launches`` counts its tile kernel's launches;
``screen_wide.launch.launches`` the wide path's.
"""
from __future__ import annotations

import torch

from repro_torch.fence import fence
from repro_torch.kernels import build, gather_screen, ref


def check_views_args(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor) -> None:
    """Validate the views screens' operands: float32 views ``[M, W, d]``
    with a unit coordinate stride, a contiguous bool/uint8 ``[M, W]`` mask
    and contiguous float32 ``self_vals [M, d]``, on one device; over the
    experiment axis views ``[E, M, W, d]``, self_vals ``[E, M, d]`` and a
    mask ``[M, W]`` or ``[E, M, W]``."""
    if views.dtype != torch.float32 or self_vals.dtype != torch.float32:
        raise TypeError(f"screening takes float32, got views {views.dtype}, "
                        f"self_vals {self_vals.dtype}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    lead = views.shape[:-3]
    if (views.ndim not in (3, 4) or self_vals.shape != (*views.shape[:-2], views.shape[-1])
            or mask.shape not in (views.shape[-3:-1], views.shape[:-1])):
        raise ValueError(f"views {tuple(views.shape)}, mask {tuple(mask.shape)} and self_vals "
                         f"{tuple(self_vals.shape)} must be [M, W, d], [M, W] and [M, d] (over "
                         f"the experiment axis [E, M, W, d], [M, W] or [E, M, W], [E, M, d])")
    if not 1 <= (lead[0] if lead else 1) <= build.MAX_EXPERIMENTS:
        raise ValueError(f"a screen takes 1 to {build.MAX_EXPERIMENTS} experiments, got {lead[0]}")
    if views.shape[-1] > 1 and views.stride(-1) != 1:
        raise ValueError("views must have a unit coordinate stride")
    if not (mask.is_contiguous() and self_vals.is_contiguous()):
        raise ValueError("mask and self_vals must be contiguous")
    if not (views.device == mask.device == self_vals.device):
        raise ValueError(f"operands on different devices: {views.device}, {mask.device}, "
                         f"{self_vals.device}")


def _screen(name: str, views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
            b) -> tuple[torch.Tensor, bool]:
    """``name``'s kernel through `gather_screen.dispatch` (``b`` None: the
    median); returns the output and whether the tile kernel ran."""
    if self_vals.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {self_vals.device}")
    m, w, d = views.shape[-3:]
    s_exp = views.stride(0) if views.ndim == 4 else 0
    out = torch.empty_like(self_vals)
    head = (views.data_ptr(), s_exp, views.stride(-3), views.stride(-2), mask.data_ptr(),
            self_vals.data_ptr(), out.data_ptr(), m, w, d,
            *build.experiments(self_vals, mask, b))
    tiled = gather_screen.dispatch(name, head, m, w, d, 4, b is None, build.stream_of(self_vals))
    return out, tiled


def views_screen_trimmed_mean(views: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor,
                              b) -> torch.Tensor:
    """Trimmed-mean screening of every node over its usable views; returns
    ``[M, d]`` float32 (``[E, M, d]`` over the experiment axis, ``b`` an
    int or an int32 ``[E]`` tensor)."""
    check_views_args(views, mask, self_vals)
    build.check_b(b, self_vals)
    if views.device.type == "cpu":
        return ref.trimmed_mean_views(views, mask, self_vals, b)
    out, tiled = _screen("views_screen_trimmed_mean", views, mask, self_vals, b)
    views_screen_trimmed_mean.launches += tiled
    return out


def views_screen_median(views: torch.Tensor, mask: torch.Tensor,
                        self_vals: torch.Tensor) -> torch.Tensor:
    """Median screening of every node over its usable views and itself;
    returns ``[M, d]`` float32 (``[E, M, d]`` over the experiment axis)."""
    check_views_args(views, mask, self_vals)
    if views.device.type == "cpu":
        return ref.median_views(views, mask, self_vals)
    out, tiled = _screen("views_screen_median", views, mask, self_vals, None)
    views_screen_median.launches += tiled
    return fence(out, "kernels.median")


views_screen_trimmed_mean.launches = 0
views_screen_median.launches = 0
