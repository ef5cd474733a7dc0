"""Asynchronous BRIDGE over an unreliable network — port of
`repro.net.async_bridge`.

`AsyncBridgeTrainer` is BRIDGE (Algorithm 1) with the message exchange
routed through an `UnreliableRuntime` (or, with ``sparse=True``, a
`SparseUnreliableRuntime`): every tick each node screens whatever messages
have arrived, the newest mailbox entry per sender no staler than
``staleness_bound`` ticks, and a node holding fewer usable messages than
its rule's Table-II minimum keeps its own iterate.  With an ideal channel
and a static schedule it equals the synchronous `BridgeTrainer` bit for bit.

The reference's hot path is one jitted ``lax.scan`` over ticks; here
`AsyncBridgeTrainer.run_scan` is a Python loop over the leading axis of
batches already stacked on the device (`repro_torch.core.bridge.stack_batches`),
the per-tick metrics stacked to ``[T]`` tensors at the end; the chunked
runner `BridgeTrainer.run_chunks` (the live metric ring, whose runtime
columns include the delivered messages' age quantiles) is inherited.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.core.bridge import (BridgeConfig, BridgeState, BridgeTrainer, stack_batches,
                                     stack_streams)
from repro_torch.net.channel import ChannelConfig
from repro_torch.net.runtime import SparseUnreliableRuntime, UnreliableRuntime


@dataclasses.dataclass(frozen=True)
class AsyncBridgeConfig(BridgeConfig):
    """`BridgeConfig` plus the network scenario: the channel, the staleness
    bound and an optional ``[T, M, M]`` schedule (`repro_torch.net.dynamic`;
    None runs the static topology).  ``trust`` (a
    `repro_torch.trust.TrustSpec`, from `BridgeConfig`) runs the trust layer
    with the echo protocol over the runtime's mailboxes."""

    channel: ChannelConfig = ChannelConfig.ideal()
    staleness_bound: int = 5
    schedule: np.ndarray | None = None


class AsyncBridgeTrainer(BridgeTrainer):
    """BRIDGE through the runtime an `AsyncBridgeConfig` describes, on
    ``device`` (``"cuda"`` by default; ``"cpu"`` runs the plain versions)."""

    def __init__(self, config: AsyncBridgeConfig, grad_fn: Callable, *,
                 device: str | torch.device = "cuda"):
        cls = SparseUnreliableRuntime if config.sparse else UnreliableRuntime
        runtime = cls(config.schedule if config.schedule is not None else config.topology,
                      config.channel, staleness_bound=config.staleness_bound, device=device)
        super().__init__(config, grad_fn, runtime=runtime, device=device)

    def run_scan(self, state: BridgeState, batches: Any) -> tuple[BridgeState, dict]:
        """One tick per leading-axis slice of ``batches`` (a tensor or a
        tuple of ``[T, ...]`` tensors); returns the final state and the
        per-tick metrics stacked to ``[T]`` tensors."""
        ticks = (batches[0] if isinstance(batches, (tuple, list)) else batches).shape[0]
        history: list[dict] = []
        for i in range(ticks):
            batch = (tuple(b[i] for b in batches) if isinstance(batches, (tuple, list))
                     else batches[i])
            state, metrics = self.step(state, batch)
            history.append(metrics)
        return state, stack_streams(history, self.device)

    def run_ticks(self, state: BridgeState, batch_fn: Callable[[int], Any],
                  num_ticks: int) -> tuple[BridgeState, dict]:
        """`run_scan` over ``num_ticks`` batches of ``batch_fn`` stacked on
        the trainer's device."""
        return self.run_scan(state, stack_batches(batch_fn, num_ticks, device=self.device))
