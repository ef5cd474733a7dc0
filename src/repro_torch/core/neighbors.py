"""Static padded neighbor-index tables — the sparse ``[M, K]`` layout; port
of `repro.core.neighbors` (``edge_id_grid`` and `NeighborTable`, built
from a static adjacency or from the union of a ``[T, M, M]`` schedule).

On the sparse graphs BRIDGE certifies (``K = max in-degree << M``), node j
only ever hears from its K in-neighbors.  ``idx[j, k]`` is the node id of
j's k-th in-neighbor (ascending), rows padded to the shared width ``K``
with the sentinel ``num_nodes``; ``valid[j, k]`` marks the real slots.
Screening then reads ``[M, K]`` slots of the ``[M, d]`` broadcast instead
of masking all M rows per node.  Padded slots are inert: their index is
clipped to a real row (``safe_idx``) and their mask is False, so widening
``k`` beyond the max in-degree changes no output bit.

The table is built once on the host; its tensors live on the device the
caller names.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def edge_id_grid(num_nodes: int) -> np.ndarray:
    """``[M, M]`` unique per-edge ids ``receiver * (M + 1) + sender`` (the
    ``M + 1`` stride keeps sentinel-padded slots collision-free)."""
    r = np.arange(num_nodes, dtype=np.int64)
    return (r[:, None] * (num_nodes + 1) + r[None, :]).astype(np.int32)


class NeighborTable:
    """Static ``[M, K]`` in-neighbor index table (see the module docstring).

    Host side: ``idx`` (int32, sentinel ``num_nodes`` in padded slots) and
    ``valid`` (bool) as numpy arrays.  Device side: ``safe_idx`` (int32, the
    sentinel clipped to ``num_nodes - 1``), ``valid_dev`` (bool) and
    ``edge_ids`` (int32, `edge_id_grid` gathered through the table).
    """

    def __init__(self, idx: np.ndarray, valid: np.ndarray, num_nodes: int, *,
                 device: str | torch.device = "cuda"):
        idx = np.asarray(idx, np.int32)
        valid = np.asarray(valid, bool)
        if idx.shape != valid.shape or idx.ndim != 2 or idx.shape[0] != num_nodes:
            raise ValueError(f"table shapes {idx.shape} / {valid.shape} must be [M={num_nodes}, K]")
        dev = resolve_device(device)
        self.idx = idx
        self.valid = valid
        self.num_nodes = int(num_nodes)
        self.k = int(idx.shape[1])
        self.device = dev
        self.safe_idx = torch.as_tensor(np.minimum(idx, num_nodes - 1), device=dev)
        self.valid_dev = torch.as_tensor(valid, device=dev)
        self.edge_ids = torch.as_tensor(
            (np.arange(num_nodes, dtype=np.int64)[:, None] * (num_nodes + 1)
             + idx.astype(np.int64)).astype(np.int32), device=dev)

    @classmethod
    def from_adjacency(cls, adjacency, k: int | None = None, *,
                       device: str | torch.device = "cuda") -> NeighborTable:
        """Table of a static ``[M, M]`` adjacency (``adjacency[j, i]``: i is
        an in-neighbor of j), or of a `Topology`.  ``k`` pads beyond the max
        in-degree; it must cover it."""
        adj = np.asarray(getattr(adjacency, "adjacency", adjacency), bool)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"adjacency must be [M, M], got {adj.shape}")
        m = adj.shape[0]
        kmax = int(adj.sum(axis=1).max()) if m else 0
        if k is None:
            k = kmax
        if k < kmax:
            raise ValueError(f"k={k} cannot hold max in-degree {kmax}")
        idx = np.full((m, k), m, np.int32)
        valid = np.zeros((m, k), bool)
        for j in range(m):
            ns = np.nonzero(adj[j])[0]
            idx[j, : len(ns)] = ns
            valid[j, : len(ns)] = True
        return cls(idx, valid, m, device=device)

    @classmethod
    def from_schedule(cls, schedule, k: int | None = None, *,
                      device: str | torch.device = "cuda") -> NeighborTable:
        """Table of the union graph of a ``[T, M, M]`` schedule: an edge
        live at any tick owns a slot for the whole run (the per-tick live
        mask, `live_schedule`, gates the sends)."""
        sched = np.asarray(schedule, bool)
        if sched.ndim != 3 or sched.shape[1] != sched.shape[2]:
            raise ValueError(f"schedule must be [T, M, M], got {sched.shape}")
        return cls.from_adjacency(sched.any(axis=0), k=k, device=device)

    def live_schedule(self, schedule) -> np.ndarray:
        """A ``[T, M, M]`` schedule gathered to the ``[T, M, K]`` per-slot
        live mask, on the host (padded slots never live)."""
        sched = np.asarray(schedule, bool)
        safe = np.minimum(self.idx, self.num_nodes - 1)
        live = np.take_along_axis(sched, safe[None].repeat(sched.shape[0], 0), axis=2)
        return live & self.valid[None]

    def gather_edges(self, mat: torch.Tensor, fill=None) -> torch.Tensor:
        """``mat [..., M, M] -> [..., M, K]``: slot (j, k) holds
        ``mat[..., j, idx[j, k]]`` (a leading axis: the grids' cells);
        ``fill`` replaces padded slots (None leaves the gathered value)."""
        idx = self.safe_idx.long().expand(*mat.shape[:-2], self.num_nodes, self.k)
        out = torch.gather(mat, -1, idx)
        return out if fill is None else torch.where(self.valid_dev, out, fill)

    def gather_rows(self, x: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """``x [M, ...] -> [M, K, ...]``: slot (j, k) holds the row of j's
        k-th in-neighbor (padded slots hold a real-but-masked row); with
        ``lead`` leading axes (the grids' cells), ``x [*lead, M, ...] ->
        [*lead, M, K, ...]``."""
        flat = x.index_select(lead, self.safe_idx.reshape(-1).long())
        return flat.reshape((*x.shape[:lead], self.num_nodes, self.k, *x.shape[lead + 1:]))

    def gather_senders(self, vec: torch.Tensor, fill=None) -> torch.Tensor:
        """``vec [..., M] -> [..., M, K]``: per-slot sender attribute (e.g.
        the Byzantine mask); ``fill`` replaces padded slots."""
        out = vec[..., self.safe_idx.long()]
        return out if fill is None else torch.where(self.valid_dev, out, fill)
