"""repro_torch.net — the unreliable-network runtime for asynchronous BRIDGE;
port of `repro.net` (without the streaming runtime's per-block mailbox).

* `channel` — per-link drop, latency, bandwidth cap and serialization;
* `dynamic` — ``[T, M, M]`` time-varying topology schedules;
* `mailbox` — per-node mailboxes with an in-flight ring;
* `runtime` — `SynchronousRuntime`, `UnreliableRuntime` and
  `SparseUnreliableRuntime`, pluggable into `BridgeTrainer(runtime=...)`;
* `async_bridge` — `AsyncBridgeTrainer`;
* `scenarios` — the named network conditions.
"""
from repro_torch.net.async_bridge import AsyncBridgeConfig, AsyncBridgeTrainer
from repro_torch.net.channel import ChannelConfig
from repro_torch.net.dynamic import (
    edge_churn,
    node_join_leave,
    node_presence_schedule,
    partition_and_heal,
    scenario_schedule,
    schedule_stats,
    static_schedule,
)
from repro_torch.net.mailbox import MailboxState, deliver, init_mailbox, push, staleness, usable_mask
from repro_torch.net.runtime import SparseUnreliableRuntime, SynchronousRuntime, UnreliableRuntime
from repro_torch.net.scenarios import NET_SCENARIOS, NetScenario, build_schedule, get_scenario

__all__ = [
    "AsyncBridgeConfig", "AsyncBridgeTrainer",
    "ChannelConfig",
    "edge_churn", "node_join_leave", "node_presence_schedule",
    "partition_and_heal", "scenario_schedule", "schedule_stats", "static_schedule",
    "MailboxState", "deliver", "init_mailbox", "push", "staleness", "usable_mask",
    "SparseUnreliableRuntime", "SynchronousRuntime", "UnreliableRuntime",
    "NET_SCENARIOS", "NetScenario", "build_schedule", "get_scenario",
]
