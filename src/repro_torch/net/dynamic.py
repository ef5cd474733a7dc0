"""Time-varying topology schedules — port of `repro.net.dynamic` (host
numpy, draw for draw the reference's).

A *schedule* is a ``[T, M, M]`` bool array: ``schedule[t, j, i]`` marks edge
i -> j live at tick t.  Generators here start from a static
`repro_torch.core.graph.Topology` (so Assumption-4 style validation applies to the
base graph) and overlay temporal structure: independent edge churn, node
join/leave, and partition-and-heal events.  The runtime indexes the schedule
with ``t mod T``, so a finite schedule repeats — build it as long as the run
when that matters.

Schedules are plain numpy on the host, built once, and copied to the
device by the runtime.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Topology


def _base_adjacency(topo) -> np.ndarray:
    adj = topo.adjacency if isinstance(topo, Topology) else np.asarray(topo)
    adj = np.asarray(adj, dtype=bool)
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    return adj


def static_schedule(topo, num_ticks: int) -> np.ndarray:
    """The trivial schedule: the same graph every tick."""
    adj = _base_adjacency(topo)
    return np.broadcast_to(adj, (num_ticks,) + adj.shape).copy()


def edge_churn(
    topo,
    num_ticks: int,
    churn_prob: float,
    *,
    seed: int = 0,
    symmetric: bool = True,
) -> np.ndarray:
    """Each base edge is independently absent with probability ``churn_prob``
    at each tick (a memoryless on/off link model).  ``symmetric=True`` churns
    both directions of a link together, matching radio-style connectivity."""
    if not 0.0 <= churn_prob < 1.0:
        raise ValueError(f"churn_prob must be in [0, 1), got {churn_prob}")
    adj = _base_adjacency(topo)
    rng = np.random.default_rng(seed)
    draw = rng.random((num_ticks,) + adj.shape)
    if symmetric:
        # one draw per undirected pair, so the pair-level churn probability is
        # exactly churn_prob (AND-ing two independent draws would double it)
        upper = np.triu(draw, 1)
        draw = upper + np.swapaxes(upper, 1, 2)
    return adj[None] & (draw >= churn_prob)


def node_presence_schedule(topo, presence: np.ndarray) -> np.ndarray:
    """Derive an edge schedule from per-node presence: ``presence[t, m]`` is
    False while node m has left the network; all its edges (both directions)
    vanish for those ticks."""
    adj = _base_adjacency(topo)
    presence = np.asarray(presence, dtype=bool)
    if presence.ndim != 2 or presence.shape[1] != adj.shape[0]:
        raise ValueError(
            f"presence must be [T, {adj.shape[0]}], got {presence.shape}"
        )
    both = presence[:, :, None] & presence[:, None, :]
    return adj[None] & both


def node_join_leave(
    topo,
    num_ticks: int,
    leave_windows: dict[int, tuple[int, int]],
) -> np.ndarray:
    """Nodes leave and rejoin: ``leave_windows[node] = (t_leave, t_rejoin)``
    removes the node's edges for ticks in ``[t_leave, t_rejoin)``."""
    adj = _base_adjacency(topo)
    presence = np.ones((num_ticks, adj.shape[0]), dtype=bool)
    for node, (lo, hi) in leave_windows.items():
        presence[lo:hi, node] = False
    return node_presence_schedule(topo, presence)


def partition_and_heal(
    topo,
    num_ticks: int,
    groups: np.ndarray,
    *,
    cut_start: int,
    cut_end: int,
) -> np.ndarray:
    """Partition event: every cross-group edge is severed during ticks
    ``[cut_start, cut_end)``, then the network heals back to the base graph.
    ``groups[m]`` assigns each node to a partition component."""
    adj = _base_adjacency(topo)
    groups = np.asarray(groups)
    if groups.shape != (adj.shape[0],):
        raise ValueError(f"groups must be [{adj.shape[0]}], got {groups.shape}")
    if not 0 <= cut_start <= cut_end <= num_ticks:
        raise ValueError(
            f"need 0 <= cut_start <= cut_end <= {num_ticks}, got "
            f"[{cut_start}, {cut_end})"
        )
    same = groups[:, None] == groups[None, :]
    sched = static_schedule(adj, num_ticks)
    sched[cut_start:cut_end] &= same[None]
    return sched


SCENARIO_KINDS = ("static", "churn", "partition", "join_leave")


def scenario_schedule(
    kind: str | None,
    topo,
    num_ticks: int,
    *,
    seed: int = 0,
    churn_prob: float = 0.3,
) -> np.ndarray | None:
    """Named *schedule* presets, the reference's (the same partition window
    and churn draws).  Channel conditions (drop, latency) are orthogonal
    and composed on top by each caller.

    ``static`` (or None) returns None (run the base topology); ``churn``
    drops each undirected pair with ``churn_prob`` per tick; ``partition``
    severs the network into index-parity halves for ticks [T/4, T/2);
    ``join_leave`` removes the last node for the same window.
    """
    T = max(num_ticks, 1)
    if kind in (None, "static"):
        return None
    if kind == "churn":
        return edge_churn(topo, T, churn_prob, seed=seed)
    lo, hi = max(T // 4, 1), max(T // 2, 2)
    if kind == "partition":
        adj = _base_adjacency(topo)
        groups = np.arange(adj.shape[0]) % 2
        return partition_and_heal(topo, T, groups, cut_start=lo, cut_end=hi)
    if kind == "join_leave":
        adj = _base_adjacency(topo)
        return node_join_leave(topo, T, {adj.shape[0] - 1: (lo, hi)})
    raise ValueError(f"unknown scenario {kind!r}; options: {list(SCENARIO_KINDS)}")


def schedule_stats(schedule: np.ndarray) -> dict:
    """Diagnostics for a schedule: worst-case / mean in-degree over time and
    the fraction of base edges live on average.  Useful for checking that a
    scenario hasn't starved a screening rule of its Table-II minimum degree
    for longer than the configured staleness bound can bridge."""
    schedule = np.asarray(schedule, dtype=bool)
    in_deg = schedule.sum(axis=2)  # [T, M]
    union = schedule.any(axis=0)
    return {
        "num_ticks": int(schedule.shape[0]),
        "min_in_degree": int(in_deg.min()),
        "mean_in_degree": float(in_deg.mean()),
        "edge_uptime": float(schedule.sum() / max(union.sum() * schedule.shape[0], 1)),
    }
