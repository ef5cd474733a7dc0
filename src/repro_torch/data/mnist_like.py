"""Synthetic MNIST-like dataset — a copy of `repro.data.mnist_like`
(pure numpy; the same seed gives the same arrays, pinned by
``tests/test_torch_data_graph.py``).

Generates 28x28 single-channel images from 10 deterministic class templates
(random low-frequency patterns) plus per-sample Gaussian noise and random
shifts.  Classes are linearly separable enough that a linear classifier
reaches high accuracy — mirroring the roles MNIST plays in the paper's
experiments (Sec. V): a well-understood convex task and a CNN task whose
*relative* degradation under Byzantine attacks is the quantity of interest.
"""
from __future__ import annotations

import numpy as np


def _templates(rng: np.random.Generator, n_classes: int) -> np.ndarray:
    """Smooth class templates: superpositions of a few 2D sinusoids."""
    yy, xx = np.mgrid[0:28, 0:28] / 28.0
    t = np.zeros((n_classes, 28, 28), np.float32)
    for c in range(n_classes):
        for _ in range(3):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.uniform(0.5, 1.0)
            t[c] += amp * np.sin(2 * np.pi * fx * xx + px) * np.sin(2 * np.pi * fy * yy + py)
        t[c] = (t[c] - t[c].min()) / (t[c].max() - t[c].min() + 1e-9)
    return t


def make_mnist_like(
    num_train: int = 6000,
    num_test: int = 1000,
    *,
    n_classes: int = 10,
    noise: float = 0.35,
    seed: int = 0,
):
    """Returns (x_train [N,784], y_train [N], x_test, y_test), float32/int32."""
    rng = np.random.default_rng(seed)
    templates = _templates(rng, n_classes)

    def gen(n):
        y = rng.integers(0, n_classes, n).astype(np.int32)
        x = templates[y].copy()
        # random +-2 pixel shift
        for i in range(n):
            sx, sy = rng.integers(-2, 3, 2)
            x[i] = np.roll(np.roll(x[i], sx, axis=0), sy, axis=1)
        x += noise * rng.standard_normal(x.shape).astype(np.float32)
        return x.reshape(n, 784).astype(np.float32), y

    x_tr, y_tr = gen(num_train)
    x_te, y_te = gen(num_test)
    mu, sd = x_tr.mean(), x_tr.std() + 1e-6
    return (x_tr - mu) / sd, y_tr, (x_te - mu) / sd, y_te
