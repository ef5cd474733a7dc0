"""Fixed-capacity per-node mailboxes with in-flight message tracking — port
of `repro.net.mailbox`: the per-link mailbox and, for the chunk-streaming
network path (`repro_torch.stream`), the per-block one
(`BlockMailboxState`).

* ``values[j, i]`` / ``send_tick[j, i]`` — the newest payload node j has
  received from sender slot i, tagged with the tick it was sent
  (`NEVER` marks an empty slot).
* ``ring_*[j, i, s]`` — in-flight messages: one sent at tick t with delay
  δ sits in ring slot ``(t + δ) mod L``, ``L = max_delay + 1``; tick t
  delivers slot ``t mod L``.

The slot axis ``W`` is ``M`` on the dense per-link layout or a
`NeighborTable`'s ``K`` on the sparse one; every function is elementwise
over ``[M, W]`` and over any leading axes ahead of them (the grids'
cells: ``values [E, M, W, d]``, ``ring_vals [E, M, W, L, d]``).  Ticks
are int32, as in the reference: ``staleness`` saturates to ``INT32_MAX``
for empty slots instead of overflowing (a Python tick against an int32
tensor stays int32).  No function but `push_block` writes into the state
it is given (the streaming step hands it the tick's own copy of a leaf's
store), and none copies a host value to the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Send tick of "nothing ever delivered on this edge".
NEVER = -(2**30)
INT32_MAX = 2**31 - 1


class MailboxState(NamedTuple):
    values: torch.Tensor  # [M, W, d] newest delivered payload per (receiver, slot)
    send_tick: torch.Tensor  # [M, W] int32 tick the stored payload was sent
    ring_vals: torch.Tensor  # [M, W, L, d] in-flight payloads by arrival slot
    ring_send: torch.Tensor  # [M, W, L] int32 send ticks of in-flight payloads
    ring_valid: torch.Tensor  # [M, W, L] bool slot occupancy

    @property
    def capacity(self) -> int:
        return self.ring_vals.shape[-2]

    def nbytes(self) -> int:
        """Device bytes of the state."""
        return sum(t.numel() * t.element_size() for t in self)


def init_mailbox(num_nodes: int, dim: int, max_delay: int, dtype=torch.float32, *,
                 width: int | None = None, lead: tuple[int, ...] = (),
                 device: str | torch.device = "cuda") -> MailboxState:
    """Empty mailboxes; ``width`` is the slot axis (``num_nodes`` by
    default, the dense layout, or a table's ``k``); ``lead`` leading axes
    (the grids' cells) ahead of every field."""
    m, L = num_nodes, max_delay + 1
    w = num_nodes if width is None else int(width)
    lead = tuple(int(x) for x in lead)
    i32 = dict(dtype=torch.int32, device=device)
    return MailboxState(
        values=torch.zeros((*lead, m, w, dim), dtype=dtype, device=device),
        send_tick=torch.full((*lead, m, w), NEVER, **i32),
        ring_vals=torch.zeros((*lead, m, w, L, dim), dtype=dtype, device=device),
        ring_send=torch.full((*lead, m, w, L), NEVER, **i32),
        ring_valid=torch.zeros((*lead, m, w, L), dtype=torch.bool, device=device),
    )


def push(state: MailboxState, msgs: torch.Tensor, send_mask: torch.Tensor,
         delay: torch.Tensor, tick: int) -> MailboxState:
    """Enqueue this tick's transmissions: ``msgs[j, i]`` goes from slot i
    to j iff ``send_mask[j, i]``, arriving ``delay[j, i]`` ticks later."""
    L = state.capacity
    slot = (delay + tick) % L  # [..., M, W] int32
    hit = send_mask[..., None] & (slot[..., None] == torch.arange(L, device=slot.device))
    return state._replace(
        ring_vals=torch.where(hit[..., None], msgs[..., None, :], state.ring_vals),
        ring_send=torch.where(hit, tick, state.ring_send),
        ring_valid=state.ring_valid | hit,
    )


def deliver(state: MailboxState, tick: int) -> tuple[MailboxState, torch.Tensor]:
    """Move every message whose arrival slot is ``tick``'s into the
    mailbox, unless the mailbox already holds one sent later; returns the
    state and the ``[..., M, W]`` arrival mask.

    The reference reads the slot as a masked sum over the ring axis; at
    ``L > 1`` its zero start turns a ``-0.0`` payload into ``+0.0``, and at
    ``L = 1`` XLA folds the one-term sum away and keeps it.  The slot is
    read here directly, with ``+ 0.0`` where the reference sums."""
    L = state.capacity
    cur = tick % L
    arrived = state.ring_valid[..., cur]
    payload = state.ring_vals[..., cur, :]
    if L > 1:
        payload = payload + 0.0
    sent_at = torch.where(arrived, state.ring_send[..., cur], 0)
    newer = arrived & (sent_at > state.send_tick)
    ring_valid = state.ring_valid.clone()
    ring_valid[..., cur] = False
    return state._replace(
        values=torch.where(newer[..., None], payload, state.values),
        send_tick=torch.where(newer, sent_at, state.send_tick),
        ring_valid=ring_valid,
    ), arrived


def staleness(state: MailboxState, tick: int) -> torch.Tensor:
    """``[M, W]`` int32 ticks since each entry was sent; empty slots
    saturate to ``INT32_MAX``."""
    st = state.send_tick
    return torch.where(st > NEVER, tick - st, INT32_MAX)


def generation_match(send_tick_a: torch.Tensor, send_tick_b: torch.Tensor) -> torch.Tensor:
    """True where two entries hold payloads of one send tick (`NEVER`
    never matches)."""
    return (send_tick_a > NEVER) & (send_tick_a == send_tick_b)


def usable_mask(state: MailboxState, tick: int, bound: int) -> torch.Tensor:
    """``[M, W]`` entries that ever arrived and are at most ``bound`` ticks
    stale (a bound on ``send_tick``, exact at any tick count)."""
    return (state.send_tick > NEVER) & (state.send_tick >= tick - bound)


# ---------------------------------------------------------------------------
# Per-block mailboxes (the chunk-streaming network path)
# ---------------------------------------------------------------------------
#
# The streaming runtime stores payloads per parameter leaf instead of one
# [M, W, d] matrix and updates them one coordinate block at a time.  The
# metadata stays one shared [M, W] ``send_tick``: every block of a tick's
# message travels the same channel, so there is one arrival event per edge
# and tick, and `staleness` / `usable_mask` apply unchanged.


class BlockMailboxState(NamedTuple):
    send_tick: torch.Tensor  # [.., M, W] int32 tick the stored payload was sent
    values: tuple  # per leaf [.., M, W, s_l] float32 newest delivered payloads


def init_block_mailbox(num_nodes: int, sizes: tuple[int, ...], *, width: int | None = None,
                       lead: tuple[int, ...] = (),
                       device: str | torch.device = "cuda") -> BlockMailboxState:
    """Empty per-block mailboxes: ``sizes`` the leaves' coordinate counts
    (`repro_torch.stream.BlockSpec`), ``width`` and ``lead`` as in
    `init_mailbox`."""
    m = num_nodes
    w = num_nodes if width is None else int(width)
    lead = tuple(int(x) for x in lead)
    return BlockMailboxState(
        send_tick=torch.full((*lead, m, w), NEVER, dtype=torch.int32, device=device),
        values=tuple(torch.zeros((*lead, m, w, s), dtype=torch.float32, device=device)
                     for s in sizes))


def stamp(send_tick: torch.Tensor, arrived: torch.Tensor, tick: int) -> torch.Tensor:
    """The shared metadata after this tick's arrivals (once a tick, outside
    the block loop)."""
    return torch.where(arrived, torch.full_like(send_tick, tick), send_tick)


def push_block(values_leaf: torch.Tensor, msgs_blk: torch.Tensor, arrived: torch.Tensor,
               start: int) -> torch.Tensor:
    """Write one coordinate block of this tick's arrivals into a leaf's
    store, in place: ``msgs_blk [.., M, W, c]`` lands at column ``start``
    of ``values_leaf [.., M, W, s]`` on the edges where ``arrived [.., M,
    W]``; dropped edges keep their previous (now stale) payload.  Returns
    ``values_leaf``."""
    c = msgs_blk.shape[-1]
    cur = values_leaf[..., start:start + c]
    cur.copy_(torch.where(arrived[..., None], msgs_blk, cur))
    return values_leaf
