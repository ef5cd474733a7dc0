"""Fixed-capacity per-node mailboxes with in-flight message tracking — port
of `repro.net.mailbox` (the per-link mailbox; the per-block one belongs to
the streaming runtime, not ported).

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
tensor stays int32).  No function writes into
the state it is given, and none copies a host value to the card.
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
