"""Dataset partitioners across decentralized nodes (paper Sec. V) — a copy
of `repro.data.partition` (pure numpy, draw-for-draw identical).

* iid — shuffle and split evenly (V-A, V-B).
* extreme non-iid — group by label; all samples of label c go to the
  num_nodes/num_classes agents assigned to c (V-C "extreme").
* moderate non-iid — each label's samples are split evenly over
  2*num_nodes/num_classes agents so every agent holds exactly two labels
  (V-C "moderate").
"""
from __future__ import annotations

import numpy as np


def partition_iid(x, y, num_nodes: int, *, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    return [
        (x[s], y[s]) for s in np.array_split(idx, num_nodes)
    ]


def partition_extreme_noniid(x, y, num_nodes: int, *, n_classes: int = 10, seed: int = 0):
    rng = np.random.default_rng(seed)
    per_class = num_nodes // n_classes
    assert per_class >= 1, "need num_nodes >= n_classes"
    shards: list = [None] * num_nodes
    node = 0
    for c in range(n_classes):
        idx = np.nonzero(y == c)[0]
        rng.shuffle(idx)
        for s in np.array_split(idx, per_class):
            shards[node] = (x[s], y[s])
            node += 1
    # any leftover nodes get iid remainder
    while node < num_nodes:
        idx = rng.permutation(len(x))[: len(x) // num_nodes]
        shards[node] = (x[idx], y[idx])
        node += 1
    return shards


def partition_moderate_noniid(x, y, num_nodes: int, *, n_classes: int = 10, seed: int = 0):
    """Each label split over 2*num_nodes/n_classes agents; each agent ends up
    with two labels."""
    rng = np.random.default_rng(seed)
    splits_per_class = 2 * num_nodes // n_classes
    pieces = []  # (class, x, y)
    for c in range(n_classes):
        idx = np.nonzero(y == c)[0]
        rng.shuffle(idx)
        for s in np.array_split(idx, splits_per_class):
            pieces.append((c, x[s], y[s]))
    rng.shuffle(pieces)
    # assign two pieces of different classes per node
    shards = []
    used = [False] * len(pieces)
    for _ in range(num_nodes):
        first = next(i for i in range(len(pieces)) if not used[i])
        used[first] = True
        second = next(
            (i for i in range(len(pieces)) if not used[i] and pieces[i][0] != pieces[first][0]),
            None,
        )
        if second is None:
            second = next(i for i in range(len(pieces)) if not used[i])
        used[second] = True
        xs = np.concatenate([pieces[first][1], pieces[second][1]])
        ys = np.concatenate([pieces[first][2], pieces[second][2]])
        shards.append((xs, ys))
    return shards


def stack_node_batches(shards, batch_size: int, *, seed: int = 0):
    """Build an infinite iterator of stacked [M, B, ...] minibatches drawn
    per-node from the given shards."""
    rng = np.random.default_rng(seed)
    m = len(shards)

    def batch_fn(step: int):
        xs, ys = [], []
        for j in range(m):
            xj, yj = shards[j]
            idx = rng.integers(0, len(xj), batch_size)
            xs.append(xj[idx])
            ys.append(yj[idx])
        return np.stack(xs), np.stack(ys)

    return batch_fn
