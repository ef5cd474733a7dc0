"""The paper's convex MNIST model (Sec. V-A) — port of the linear half of
`repro.models.small`: the one-vs-all linear classifier with squared hinge
loss.  Parameters are a dict ``{"b": [.., C], "w": [.., d_in, C]}``.

The reference takes a per-node ``jax.value_and_grad`` under ``vmap``; the
port writes the gradient of the squared hinge in closed form over the
stacked ``[M, ...]`` node axis (one batched product per tick instead of M
small ones).  The products go to ``torch.matmul``, as the reference leaves
them to XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device

L2 = 1e-4  # the reference's default ``l2``


def init_linear(key: np.ndarray, d_in: int = 784, n_classes: int = 10, *,
                device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """``w = 0.01 * normal(key, (d_in, C))``, ``b = 0`` on ``device`` — the
    reference's init, drawn from its Threefry stream (`repro_torch.prng`)."""
    dev = resolve_device(device)
    return {"w": 0.01 * prng.normal(key, (d_in, n_classes), dev),
            "b": torch.zeros((n_classes,), device=dev)}


def _targets(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """+-1 one-vs-all targets of integer labels ``y``."""
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).to(torch.float32)
    return 2.0 * onehot - 1.0


def linear_loss(params: dict[str, torch.Tensor], batch, *, l2: float = L2) -> torch.Tensor:
    """One node's loss: ``batch = (x [N, d_in], y [N])``."""
    x, y = batch
    scores = x @ params["w"] + params["b"]
    margins = torch.clamp(1.0 - _targets(y, scores.shape[-1]) * scores, min=0.0)
    loss = torch.mean(torch.sum(margins**2, dim=-1), dim=-1)
    return loss + l2 * (torch.sum(params["w"] ** 2) + torch.sum(params["b"] ** 2))


def linear_loss_and_grad(params: dict[str, torch.Tensor], batch, *, l2: float = L2):
    """Per-node loss and gradient over stacked nodes: ``params`` leaves are
    ``[M, ...]``, ``batch = (x [M, N, d_in], y [M, N])``.  Returns
    ``(losses [M], grads)`` with ``grads`` shaped like ``params``.

    The grids' experiment axis: leaves ``[E, M, ...]`` under the tick's one
    batch, shared by every cell as in the reference (``losses [E, M]``);
    the two products then run as one batched product over the E M nodes
    (each node's product is its own matrix's, which the card computes as
    in the ``[M]`` call: ``chip_smoke.py`` holds every grid cell to its own
    trainer run).

    d/ds of ``mean_n sum_c max(0, 1 - t s)^2`` is ``-2 t max(0, 1 - t s) / N``;
    the L2 term adds ``2 l2 p`` to each leaf."""
    x, y = batch
    w, b = params["w"], params["b"]
    scores = torch.matmul(x, w) + b[..., None, :]  # [(E,) M, N, C]
    t = _targets(y, scores.shape[-1])
    margins = torch.clamp(1.0 - t * scores, min=0.0)
    n = x.shape[-2]
    reg_w = torch.sum(w * w, dim=(-2, -1))
    reg_b = torch.sum(b * b, dim=-1)
    losses = torch.mean(torch.sum(margins * margins, dim=-1), dim=-1) + l2 * (reg_w + reg_b)
    g_scores = (-2.0 / n) * t * margins  # [(E,) M, N, C]
    grad_w = torch.matmul(x.transpose(-2, -1), g_scores) + (2.0 * l2) * w
    grad_b = torch.sum(g_scores, dim=-2) + (2.0 * l2) * b
    return losses, {"b": grad_b, "w": grad_w}


def linear_accuracy(params: dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One node's test accuracy (a 0-d float32 tensor)."""
    pred = torch.argmax(x @ params["w"] + params["b"], dim=1)
    return torch.mean((pred == y).to(torch.float32))
