"""Per-link channel models of the unreliable-network runtime — port of
`repro.net.channel`.

A channel decides, for every directed edge (i -> j) at every tick, whether
the message is dropped, how many ticks it spends in flight, and how much of
the payload survives a bandwidth cap.  Everything is drawn from the tick's
Threefry key (`repro_torch.prng`), so a seed reproduces the reference's
loss and latency trace draw for draw.  Draws are shape-static: ``[M, M]``
whatever the live edges.  Over the grids' cells (``lead = (E,)``) the key
is the cells' host row keys ``[E, 2]`` (`repro_torch.prng`) and row e is
the draw cell e's own key makes; one key with ``lead = (1,)`` draws the
one-cell trace.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.comm.codec import top_indices


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Stochastic properties of every link (the reference's fields).

    ``drop_prob``: i.i.d. per-edge per-tick loss probability.
    ``latency_min`` / ``latency_max``: delay in ticks, uniform over the
    inclusive range (0: delivered the tick it was sent).
    ``bandwidth_cap``: only this many coordinates of a payload travel, a
    subset drawn afresh each tick; the rest is backfilled with the
    receiver's iterate of the send tick.
    ``bits_per_tick``: the link's serialization capacity; a message of
    ``wire_bits`` occupies it ``ceil(wire_bits / bits_per_tick)`` ticks,
    the excess over one added to the drawn latency.
    """

    drop_prob: float = 0.0
    latency_min: int = 0
    latency_max: int = 0
    bandwidth_cap: int | None = None
    bits_per_tick: int | None = None

    def __post_init__(self):
        if not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError(f"drop_prob must be in [0, 1], got {self.drop_prob}")
        if self.latency_min < 0 or self.latency_max < self.latency_min:
            raise ValueError(f"need 0 <= latency_min <= latency_max, got "
                             f"[{self.latency_min}, {self.latency_max}]")
        if self.bandwidth_cap is not None and self.bandwidth_cap < 1:
            raise ValueError(f"bandwidth_cap must be >= 1, got {self.bandwidth_cap}")
        if self.bits_per_tick is not None and self.bits_per_tick < 1:
            raise ValueError(f"bits_per_tick must be >= 1, got {self.bits_per_tick}")

    @classmethod
    def ideal(cls) -> ChannelConfig:
        """Zero latency, zero drop, unlimited bandwidth: the channel under
        which the runtime reproduces the synchronous path bit for bit."""
        return cls()

    @property
    def is_ideal(self) -> bool:
        return (self.drop_prob == 0.0 and self.latency_max == 0
                and self.bandwidth_cap is None and self.bits_per_tick is None)

    @property
    def max_latency(self) -> int:
        return self.latency_max

    def serial_ticks(self, wire_bits: int | None) -> int:
        """Extra delay ticks a ``wire_bits``-bit message spends serializing
        onto the link (0 when uncapped or when it fits in one tick)."""
        if self.bits_per_tick is None or wire_bits is None:
            return 0
        return max((int(wire_bits) + self.bits_per_tick - 1) // self.bits_per_tick - 1, 0)

    def max_total_latency(self, max_wire_bits: int | None) -> int:
        """Worst-case delivery delay: propagation plus the serialization of
        the largest codeword the run can emit (sizes the mailbox ring)."""
        return self.latency_max + self.serial_ticks(0 if max_wire_bits is None else max_wire_bits)

    def sample(self, key: np.ndarray, num_nodes: int, device: str | torch.device,
               lead: tuple[int, ...] = ()) -> tuple[torch.Tensor, torch.Tensor]:
        """One tick of channel events: ``(delay [*lead, M, M] int32, drop
        [*lead, M, M] bool)`` under ``split(key)``'s two subkeys, non-edges
        included."""
        keys = prng.split(key)
        k_delay, k_drop = keys[..., 0, :], keys[..., 1, :]
        shape = (*lead, num_nodes, num_nodes)
        if self.latency_max > self.latency_min:
            delay = prng.randint(k_delay, shape, self.latency_min, self.latency_max + 1,
                                 torch.int32, device)
        else:
            delay = torch.full(shape, self.latency_min, dtype=torch.int32, device=device)
        if self.drop_prob > 0.0:
            drop = prng.uniform(k_drop, shape, device) < float(np.float32(self.drop_prob))
        else:
            drop = torch.zeros(shape, dtype=torch.bool, device=device)
        return delay, drop

    def coord_mask(self, key: np.ndarray, d: int, device: str | torch.device,
                   lead: tuple[int, ...] = ()) -> torch.Tensor | None:
        """``[*lead, d]`` bool marking this tick's ``bandwidth_cap``
        transmitted coordinates (the top of ``d`` uniforms, ``lax.top_k``'s
        order), or None when uncapped."""
        if self.bandwidth_cap is None or self.bandwidth_cap >= d:
            return None
        idx = top_indices(prng.uniform(key, (*lead, d), device), self.bandwidth_cap)
        mask = torch.zeros((*lead, d), dtype=torch.bool, device=device)
        return mask.scatter_(-1, idx.long(), True)
