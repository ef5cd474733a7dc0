"""Network runtimes: how messages move between BRIDGE nodes each tick —
port of `repro.net.runtime`.

A runtime plugs into `repro_torch.core.bridge.BridgeTrainer` through its
``runtime=`` argument.  The contract:

* ``init(num_nodes, dim, max_wire_bits) -> net_state`` — carried in
  ``BridgeState.net``;
* ``adjacency_at(t)`` — the tick's live edges, ``[M, M]`` bool (dense) or
  the ``[M, K]`` live-slot mask (sparse), on the runtime's device;
* ``exchange(net_state, msgs, self_vals, adjacency, key, t, *, wire_bits)
  -> (net_state, views [M, W, d], mask [M, W], stats)`` — moves this
  tick's ``msgs[receiver, sender]`` through the network and returns each
  node's current views of its senders and the usable-entry mask.  It never
  writes into the state it is given.

`SynchronousRuntime` delivers every live edge instantly; `UnreliableRuntime`
composes a `ChannelConfig`, a ``[T, M, M]`` schedule and per-node mailboxes;
`SparseUnreliableRuntime` is the latter on the neighbor-indexed ``[M, K]``
layout, its channel events drawn on the dense ``[M, M]`` grid and gathered,
so the two are bit-identical at equal seed.  ``t`` is the tick as a Python
int and ``key`` a host Threefry key (`repro_torch.prng`); the stats are
0-d float32 tensors on the device, computed as the reference computes them.

Stacked cells.  `exchange` also takes leading axes ahead of the messages'
``[M, W, d]`` (the grids' cells: ``[E, M, W, d]``, mailbox state
``[E, M, W, L, d]``, a live mask ``[M, W]`` every cell shares or
``[E, M, W]``, and ``key`` one key or the cells' host row keys ``[E, 2]``):
every channel draw, mailbox step and stat is then per cell, row e bit for
bit the one-cell exchange under key e, and the stats are ``[E]`` (each
cell's counts summed over its own ``[M, W]``).

Divisors.  The reference's schedule is a closed-over constant indexed by
``t mod T``; with a static schedule (``T = 1``) XLA folds the index, so the
tick's live-edge count is a constant and ``delivered_frac``'s division by
it becomes a multiply by its float32 reciprocal, as does every division by
the constant ``M``.  The runtimes write those forms (`static_live`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.neighbors import NeighborTable
from repro_torch.device import resolve_device
from repro_torch.net import mailbox as mb
from repro_torch.net.channel import ChannelConfig
from repro_torch.net.dynamic import static_schedule


def static_live(schedule: np.ndarray) -> int | None:
    """The live-edge (or live-slot) count of a one-tick schedule, a
    constant of the reference's program; None when the schedule varies."""
    return int(schedule[0].sum()) if schedule.shape[0] == 1 else None


def _as_schedule(topology_or_schedule) -> np.ndarray:
    """A Topology, an ``[M, M]`` adjacency or a ``[T, M, M]`` schedule, as
    a host ``[T, M, M]`` bool array."""
    arr = np.asarray(getattr(topology_or_schedule, "adjacency", topology_or_schedule), bool)
    if arr.ndim == 2:
        arr = static_schedule(arr, 1)
    if arr.ndim != 3 or arr.shape[1] != arr.shape[2]:
        raise ValueError(f"schedule must be [T, M, M], got {arr.shape}")
    return arr


def _count(x: torch.Tensor) -> torch.Tensor:
    """``sum(x)`` over the last two axes (a cell's ``[M, W]``) as float32,
    as the reference's ``jnp.sum(...)`` promoted for a float division."""
    return torch.sum(x, dim=(-2, -1)).to(torch.float32)


def _per_node(count: torch.Tensor, m: int) -> torch.Tensor:
    """``count / max(m, 1)`` for a constant ``m``, as XLA computes it: a
    multiply by the float32 reciprocal."""
    return count * float(np.float32(1.0) / np.float32(max(m, 1)))


def _mailbox_stats(net: mb.MailboxState, arrived, live, mask, t: int, m: int,
                   static_live: int | None) -> dict:
    """The reference's stats of a mailbox exchange; ``static_live`` is the
    live-edge count of a static schedule (a constant: XLA's reciprocal
    form), None for a time-varying one."""
    stale = torch.where(mask, mb.staleness(net, t), 0)
    live = live.expand(arrived.shape)
    delivered = _count(arrived & live)
    return {
        "delivered_frac": (delivered / torch.clamp(_count(live), min=1.0) if static_live is None
                           else _per_node(delivered, static_live)),
        "mean_staleness": torch.sum(stale, dim=(-2, -1)).to(torch.float32)
        / torch.clamp(_count(mask), min=1.0),
        "active_links": _per_node(_count(live), m),
        # usable entries can exceed active_links: fresh mailbox values from
        # edges that churned away count until they go stale
        "usable_in": _per_node(_count(mask), m),
    }


class SynchronousRuntime:
    """The ideal network: every live edge delivers the fresh message within
    the tick; the views are the message tensor itself (for a lifted
    broadcast attack, the broadcast expanded with a receiver stride of 0)."""

    def __init__(self, topology_or_schedule, *, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._schedule = torch.as_tensor(_as_schedule(topology_or_schedule), device=self.device)

    def describe(self) -> dict:
        return {"runtime": "synchronous", "num_nodes": int(self._schedule.shape[1]),
                "num_ticks": self.num_ticks}

    @property
    def num_ticks(self) -> int:
        return self._schedule.shape[0]

    def adjacency_at(self, t: int) -> torch.Tensor:
        return self._schedule[t % self.num_ticks]

    def init(self, num_nodes: int, dim: int, max_wire_bits: int | None = None):
        del num_nodes, dim, max_wire_bits
        return None

    def exchange(self, net_state, msgs, self_vals, adjacency, key, t, *, wire_bits=None):
        del self_vals, key, t, wire_bits
        lead = msgs.shape[:-3]
        adjacency = adjacency.expand(*lead, *adjacency.shape[-2:])
        links = _per_node(_count(adjacency), adjacency.shape[-2])
        dev = adjacency.device
        stats = {"delivered_frac": torch.ones(lead, device=dev),
                 "mean_staleness": torch.zeros(lead, device=dev),
                 "active_links": links, "usable_in": links}
        return net_state, msgs, adjacency, stats


class UnreliableRuntime:
    """Lossy, delayed, bandwidth-capped, time-varying exchange.  Per tick:
    draw per-edge drop and delay, enqueue the surviving messages, deliver
    what arrives now, and expose the mailbox entries no staler than
    ``staleness_bound`` ticks.  Under a bandwidth cap the untransmitted
    coordinates are backfilled at send time with the receiver's iterate."""

    def __init__(self, topology_or_schedule, channel: ChannelConfig = ChannelConfig.ideal(), *,
                 staleness_bound: int = 5, device: str | torch.device = "cuda"):
        if staleness_bound < 0:
            raise ValueError(f"staleness_bound must be >= 0, got {staleness_bound}")
        self.device = resolve_device(device)
        sched = _as_schedule(topology_or_schedule)
        self._schedule = torch.as_tensor(sched, device=self.device)
        self._static_live = static_live(sched)
        self.channel = channel
        self.staleness_bound = staleness_bound

    def describe(self) -> dict:
        return {"runtime": "unreliable", "num_nodes": int(self._schedule.shape[1]),
                "num_ticks": self.num_ticks, "staleness_bound": self.staleness_bound,
                "channel": dataclasses.asdict(self.channel)}

    @property
    def num_ticks(self) -> int:
        return self._schedule.shape[0]

    def adjacency_at(self, t: int) -> torch.Tensor:
        return self._schedule[t % self.num_ticks]

    def init(self, num_nodes: int, dim: int, max_wire_bits: int | None = None) -> mb.MailboxState:
        if num_nodes != self._schedule.shape[1]:
            raise ValueError(f"runtime schedule is for {self._schedule.shape[1]} nodes, "
                             f"trainer has {num_nodes}")
        # the ring holds the worst case: propagation plus the serialization
        # of the largest codeword (a float32 payload when no bound is given)
        bits = 32 * dim if max_wire_bits is None else max_wire_bits
        return mb.init_mailbox(num_nodes, dim, self.channel.max_total_latency(bits),
                               device=self.device)

    def delivered_coord_mask(self, key: np.ndarray, d: int) -> torch.Tensor | None:
        """The coordinate subset `exchange` delivers under this tick's
        ``key`` (None when uncapped): the same stream as `exchange`'s."""
        if self.channel.bandwidth_cap is None:
            return None
        return self.channel.coord_mask(prng.split(key)[1], d, self.device)

    def _events(self, key: np.ndarray, m: int, lead: tuple[int, ...]):
        """The tick's dense ``(delay, drop)`` draw and the coordinate key:
        the coordinate stream splits off only under a bandwidth cap (per
        cell under row keys), so uncapped channels keep the reference's
        drop and latency trace."""
        k_coord = key
        if self.channel.bandwidth_cap is not None:
            keys = prng.split(key)
            key, k_coord = keys[..., 0, :], keys[..., 1, :]
        delay, drop = self.channel.sample(key, m, self.device, lead)
        return delay, drop, k_coord

    def _send(self, net_state, msgs, self_vals, live, delay, drop, k_coord, t, wire_bits):
        delay = delay + self.channel.serial_ticks(wire_bits)
        send_mask = live & ~drop
        cm = self.channel.coord_mask(k_coord, msgs.shape[-1], self.device, msgs.shape[:-3])
        if cm is not None:
            msgs = torch.where(cm[..., None, None, :], msgs, self_vals[..., None, :])
        net_state = mb.push(net_state, msgs, send_mask, delay, t)
        net_state, arrived = mb.deliver(net_state, t)
        mask = mb.usable_mask(net_state, t, self.staleness_bound)
        stats = _mailbox_stats(net_state, arrived, live, mask, t, live.shape[-2],
                               self._static_live)
        return net_state, net_state.values, mask, stats

    def exchange(self, net_state, msgs, self_vals, adjacency, key, t, *, wire_bits=None):
        delay, drop, k_coord = self._events(key, adjacency.shape[-2], msgs.shape[:-3])
        return self._send(net_state, msgs, self_vals, adjacency, delay, drop, k_coord, t,
                          wire_bits)


class SparseUnreliableRuntime(UnreliableRuntime):
    """`UnreliableRuntime` on the neighbor-indexed ``[M, K]`` layout: a
    static `NeighborTable` of the schedule's union keys the mailbox
    (``[M, K, L, d]``), the live and usable masks (``[M, K]``) and the
    message tensors (``[M, K, d]``).  Channel events are drawn on the dense
    ``[M, M]`` grid and gathered through the table, which keeps the trace,
    and the trajectory, bit-identical to the dense runtime at equal seed.
    ``adjacency_at`` returns the ``[M, K]`` live-slot mask."""

    def __init__(self, topology_or_schedule, channel: ChannelConfig = ChannelConfig.ideal(), *,
                 staleness_bound: int = 5, k: int | None = None,
                 neighbors: NeighborTable | None = None, device: str | torch.device = "cuda"):
        if staleness_bound < 0:
            raise ValueError(f"staleness_bound must be >= 0, got {staleness_bound}")
        self.device = resolve_device(device)
        sched = _as_schedule(topology_or_schedule)
        self.channel = channel
        self.staleness_bound = staleness_bound
        self.neighbors = (neighbors if neighbors is not None
                          else NeighborTable.from_schedule(sched, k=k, device=self.device))
        if self.neighbors.num_nodes != sched.shape[1]:
            raise ValueError(f"neighbor table is for {self.neighbors.num_nodes} nodes, "
                             f"schedule has {sched.shape[1]}")
        live = self.neighbors.live_schedule(sched)  # [T, M, K]
        self._schedule = torch.as_tensor(live, device=self.device)
        self._static_live = static_live(live)

    def describe(self) -> dict:
        return {"runtime": "sparse_unreliable", "num_nodes": self.neighbors.num_nodes,
                "num_ticks": self.num_ticks, "staleness_bound": self.staleness_bound,
                "k": self.neighbors.k, "channel": dataclasses.asdict(self.channel)}

    def init(self, num_nodes: int, dim: int, max_wire_bits: int | None = None) -> mb.MailboxState:
        if num_nodes != self.neighbors.num_nodes:
            raise ValueError(f"runtime table is for {self.neighbors.num_nodes} nodes, "
                             f"trainer has {num_nodes}")
        bits = 32 * dim if max_wire_bits is None else max_wire_bits
        return mb.init_mailbox(num_nodes, dim, self.channel.max_total_latency(bits),
                               width=self.neighbors.k, device=self.device)

    def exchange(self, net_state, msgs, self_vals, live, key, t, *, wire_bits=None):
        nbr = self.neighbors
        delay_d, drop_d, k_coord = self._events(key, nbr.num_nodes, msgs.shape[:-3])
        return self._send(net_state, msgs, self_vals, live, nbr.gather_edges(delay_d),
                          nbr.gather_edges(drop_d, fill=True), k_coord, t, wire_bits)
