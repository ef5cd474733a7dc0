"""The MNIST-like linear task — port of `repro.sim.tasks.linear_task`: the
same data, partition and per-tick batches (numpy, draw-for-draw identical),
the linear squared-hinge model, and honest-node test accuracy.

The reference also returns the batches stacked over ticks for its
scan-over-ticks paths; the port runs ticks in a Python loop and returns the
per-tick ``batch_fn`` only.
"""
from __future__ import annotations

import functools
from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.bridge import replicate
from repro_torch.data.mnist_like import make_mnist_like
from repro_torch.data.partition import (
    partition_extreme_noniid,
    partition_iid,
    partition_moderate_noniid,
    stack_node_batches,
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
    grad_fn: Callable  # (params [M, ...], batch) -> (losses [M], grads)
    init_fn: Callable  # seed -> [M, ...] replicated params on the device
    batch_fn: Callable  # tick -> (x [M, B, 784], y [M, B]) on the device
    eval_accuracy: Callable  # (params [M, ...], honest_mask [M]) -> mean honest accuracy
    x_test: torch.Tensor
    y_test: torch.Tensor


def linear_task(num_nodes: int, *, partition: str = "extreme", batch: int = 32,
                num_train: int = 2000, num_test: int = 400, seed: int = 0,
                device: str | torch.device = "cuda") -> LinearTask:
    """Assemble the linear task for ``num_nodes`` nodes on ``device``.
    ``partition="extreme"`` (each node sees one class) needs
    ``num_nodes >= 10``."""
    dev = resolve_device(device)
    part = {"iid": partition_iid, "extreme": partition_extreme_noniid,
            "moderate": partition_moderate_noniid}[partition]
    x, y, xt, yt = dataset(num_train, num_test, seed)
    shards = part(x, y, num_nodes, seed=seed)
    host_batches = stack_node_batches(shards, batch, seed=seed)
    x_test = torch.as_tensor(xt, device=dev)
    y_test = torch.as_tensor(yt, device=dev)

    def batch_fn(i: int):
        bx, by = host_batches(i)
        return torch.as_tensor(bx, device=dev), torch.as_tensor(by, device=dev)

    def init_fn(seed: int):
        # the reference's init: one key for the model draw and the perturbation
        key = prng.PRNGKey(seed)
        return replicate(small.init_linear(key, device=dev), num_nodes, perturb=0.01, key=key)

    def eval_accuracy(params, honest_mask) -> float:
        return honest_accuracy(params, honest_mask, x_test, y_test)

    return LinearTask(small.linear_loss_and_grad, init_fn, batch_fn, eval_accuracy,
                      x_test, y_test)


def honest_accuracy(params, honest_mask, x_test: torch.Tensor, y_test: torch.Tensor) -> float:
    """Mean test accuracy of the linear model over the honest nodes (the
    paper's metric); 0.0 when no node is honest."""
    scores = torch.matmul(x_test, params["w"]) + params["b"][:, None, :]  # [M, N, C]
    acc = (torch.argmax(scores, dim=2) == y_test[None]).to(torch.float32).mean(dim=1)
    honest = torch.as_tensor(honest_mask, device=x_test.device, dtype=torch.bool)
    if not bool(honest.any()):
        return 0.0
    return float(acc[honest].mean())
