"""Dataset partitioners across decentralized nodes (paper Sec. V) — a copy
of `repro.data.partition` (numpy, draw-for-draw identical), and the
per-node minibatches gathered on the device (`device_node_batches`).

* iid — shuffle and split evenly (V-A, V-B).
* extreme non-iid — group by label; all samples of label c go to the
  num_nodes/num_classes agents assigned to c (V-C "extreme").
* moderate non-iid — each label's samples are split evenly over
  2*num_nodes/num_classes agents so every agent holds exactly two labels
  (V-C "moderate").
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from repro_torch.device import resolve_device


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


class _DeviceNodeBatches:
    """`device_node_batches`' drawer (its docstring says what it draws)."""

    def __init__(self, shards, batch_size: int, *, seed: int, device: str | torch.device):
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._lens = np.asarray([len(x) for x, _ in shards], np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(self._lens)[:-1]]).astype(np.int64)
        self._x = torch.as_tensor(np.concatenate([x for x, _ in shards]), device=self.device)
        self._y = torch.as_tensor(np.concatenate([y for _, y in shards]), device=self.device)
        self._pinned: torch.Tensor | None = None
        self._copied = None  # the event after the last copy out of the pinned buffer

    def replay(self) -> _DeviceNodeBatches:
        """A drawer over the same resident shards whose generator starts
        again at ``seed``: it replays this one's sequence from the start."""
        other = copy.copy(self)
        other._rng = np.random.default_rng(self.seed)
        other._pinned = other._copied = None
        return other

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        n = rows.size
        if self._pinned is None or self._pinned.numel() < n:
            self._pinned = torch.empty(n, dtype=torch.int64, pin_memory=True)
            self._copied = None
        if self._copied is not None:
            self._copied.synchronize()  # the previous copy has left the buffer
        self._pinned[:n].numpy()[:] = rows
        out = self._pinned[:n].to(self.device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        return out

    def __call__(self, step: int = 0):
        del step  # as in the reference: every call draws the next tick
        x, y = self.stacked(1)
        return x[0], y[0]

    def stacked(self, ticks: int):
        """The next ``ticks`` ticks in one host draw, one copy and one
        gather: ``(x [T, M, B, ...], y [T, M, B])``."""
        shape = (ticks, len(self._lens), self.batch_size)
        rows = self._rng.integers(0, np.broadcast_to(self._lens[None, :, None], shape), shape)
        flat = self._to_device((rows + self._offsets[None, :, None]).reshape(-1))
        x = self._x.index_select(0, flat).reshape(*shape, *self._x.shape[1:])
        return x, self._y.index_select(0, flat).reshape(shape)


def device_node_batches(shards, batch_size: int, *, seed: int = 0,
                        device: str | torch.device) -> _DeviceNodeBatches:
    """The device form of `stack_node_batches`: the same minibatches, with
    the shards resident on ``device`` and each draw gathered there.

    The shards are concatenated as ``x [N, ...]`` and ``y [N]`` with
    per-node row offsets.  The row indices are drawn on the host from one
    ``default_rng(seed)`` in the reference's order (tick by tick, node by
    node, ``integers(0, len(shard_j), B)`` each): one ``integers`` call
    over ``[T, M, B]`` with each node's bound broadcast draws exactly the
    values of that loop of calls.  The rows cross in one copy (on the card
    from a pinned buffer) and one gather on the device picks the samples,
    so every batch equals `stack_node_batches`' bit for bit.

    The drawer's ``(step)`` call is one tick ``(x [M, B, ...], y [M, B])``
    and, as in the reference, ignores ``step``: each call advances the
    generator.  ``.stacked(T)`` draws T ticks at once, ``(x [T, M, B,
    ...], y [T, M, B])``.  ``.replay()`` is a fresh drawer over the same
    resident shards.
    """
    return _DeviceNodeBatches(shards, batch_size, seed=seed, device=device)
