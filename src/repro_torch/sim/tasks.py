"""The MNIST-like linear task — port of `repro.sim.tasks.linear_task`: the
same data, partition and per-tick batches (draw-for-draw the reference's),
the linear squared-hinge model, and honest-node test accuracy.

Breakdown certification (`repro_torch.adversary.breakdown`, ``sweep --mode
breakdown``) and the red-team search (`repro_torch.adversary.search`) run
this task over ``ticks`` batches stacked on the device (``batches``); the
trainers step through ``batch_fn``, a fresh drawer that replays the same
sequence.  Both gather on the device from the shards held there
(`repro_torch.data.partition.device_node_batches`).
"""
from __future__ import annotations

import functools
from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.bridge import replicate
from repro_torch.data.mnist_like import make_mnist_like
from repro_torch.data.partition import (
    partition_extreme_noniid,
    partition_iid,
    partition_moderate_noniid,
    device_node_batches,
)
from repro_torch.device import resolve_device
from repro_torch.models import small


@functools.cache
def dataset(num_train: int, num_test: int, seed: int):
    """`make_mnist_like` at these sizes and seed, made once per process: a
    task's partition, batches and test tensors read its arrays and never
    write them."""
    return make_mnist_like(num_train, num_test, seed=seed)


class LinearTask(NamedTuple):
    """Everything a trainer or a grid needs to run and score the task (the
    reference's fields, in its order)."""

    grad_fn: Callable  # (params [..., M, ...], batch) -> (losses [..., M], grads)
    init_fn: Callable  # seed -> [M, ...] replicated params on the device
    # (x [T, M, B, 784], y [T, M, B]) on the device; None when ticks == 0
    batches: Any
    eval_accuracy: Callable  # (params [M, ...], honest_mask [M]) -> mean honest accuracy
    x_test: torch.Tensor
    y_test: torch.Tensor
    # a fresh per-tick drawer, tick -> (x [M, B, 784], y [M, B]) on the
    # device: it replays the sequence `batches` holds from its first tick
    batch_fn: Callable = None


def linear_task(num_nodes: int, ticks: int = 0, *, partition: str = "extreme", batch: int = 32,
                num_train: int = 2000, num_test: int = 400, seed: int = 0,
                device: str | torch.device = "cuda") -> LinearTask:
    """Assemble the linear task for ``num_nodes`` nodes on ``device``, with
    ``ticks`` batches stacked (``ticks == 0``: ``batches`` is None).
    ``partition="extreme"`` (each node sees one class) needs
    ``num_nodes >= 10``."""
    dev = resolve_device(device)
    part = {"iid": partition_iid, "extreme": partition_extreme_noniid,
            "moderate": partition_moderate_noniid}[partition]
    x, y, xt, yt = dataset(num_train, num_test, seed)
    shards = part(x, y, num_nodes, seed=seed)
    drawer = device_node_batches(shards, batch, seed=seed, device=dev)
    batches = drawer.stacked(ticks) if ticks > 0 else None
    x_test = torch.as_tensor(xt, device=dev)
    y_test = torch.as_tensor(yt, device=dev)

    def init_fn(seed: int):
        # the reference's init: one key for the model draw and the perturbation
        key = prng.PRNGKey(seed)
        return replicate(small.init_linear(key, device=dev), num_nodes, perturb=0.01, key=key)

    def eval_accuracy(params, honest_mask) -> float:
        return honest_accuracy(params, honest_mask, x_test, y_test)

    return LinearTask(small.linear_loss_and_grad, init_fn, batches, eval_accuracy,
                      x_test, y_test, batch_fn=drawer.replay())


def honest_accuracy(params, honest_mask, x_test: torch.Tensor, y_test: torch.Tensor) -> float:
    """Mean test accuracy of the linear model over the honest nodes (the
    paper's metric); 0.0 when no node is honest."""
    scores = torch.matmul(x_test, params["w"]) + params["b"][:, None, :]  # [M, N, C]
    acc = (torch.argmax(scores, dim=2) == y_test[None]).to(torch.float32).mean(dim=1)
    honest = torch.as_tensor(honest_mask, device=x_test.device, dtype=torch.bool)
    if not bool(honest.any()):
        return 0.0
    return float(acc[honest].mean())
