"""The named network conditions — port of `repro.net.scenarios`: a
`ChannelConfig`, an optional topology-dynamics kind
(`repro_torch.net.dynamic.scenario_schedule`) and the staleness bound
asynchronous screening tolerates, under the reference's labels.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Topology, make_topology
from repro_torch.net.channel import ChannelConfig
from repro_torch.net.dynamic import scenario_schedule, static_schedule


@dataclasses.dataclass(frozen=True)
class NetScenario:
    """One named network condition.  ``topology`` optionally names a
    `repro_torch.core.graph.TOPOLOGIES` spec the scenario bundles (the
    large-graph families, for the sparse layout); None leaves the graph to
    the caller."""

    name: str
    channel: ChannelConfig = ChannelConfig.ideal()
    schedule_kind: str | None = None  # dynamic.scenario_schedule kind; None = static
    staleness_bound: int = 5
    churn_prob: float = 0.3
    topology: str | None = None  # repro_torch.core.graph.make_topology spec


NET_SCENARIOS: dict[str, NetScenario] = {
    s.name: s
    for s in (
        NetScenario("ideal", ChannelConfig.ideal(), None, 0),
        NetScenario("lossy", ChannelConfig(drop_prob=0.2)),
        NetScenario("laggy", ChannelConfig(latency_max=3)),
        NetScenario("lossy_laggy", ChannelConfig(drop_prob=0.2, latency_max=3)),
        NetScenario("bandwidth64", ChannelConfig(bandwidth_cap=64)),
        # serialization-limited: a float32 payload of d ~ 8k spends extra
        # ticks on the wire that an int8 codeword does not
        NetScenario("narrowband64k", ChannelConfig(bits_per_tick=1 << 16)),
        NetScenario("churn", schedule_kind="churn"),
        NetScenario("partition", schedule_kind="partition"),
        NetScenario("smallworld_lossy", ChannelConfig(drop_prob=0.1), topology="small_world:6"),
        NetScenario("geometric_churn", schedule_kind="churn", churn_prob=0.2,
                    topology="geometric"),
        NetScenario("torus_laggy", ChannelConfig(latency_max=2), topology="torus"),
    )
}


def build_topology(scenario: NetScenario, num_nodes: int, num_byzantine: int, *,
                   seed: int = 0) -> Topology:
    """The scenario's bundled topology; raises for scenarios that leave the
    graph to the caller."""
    if scenario.topology is None:
        raise ValueError(f"scenario {scenario.name!r} does not bundle a topology; "
                         f"construct one via repro_torch.core.graph")
    return make_topology(scenario.topology, num_nodes, num_byzantine, seed=seed)


def get_scenario(name: str) -> NetScenario:
    try:
        return NET_SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown net scenario {name!r}; options: {sorted(NET_SCENARIOS)}") \
            from None


def build_schedule(scenario: NetScenario, topology, num_ticks: int, *, seed: int = 0
                   ) -> np.ndarray:
    """The scenario's full-length ``[num_ticks, M, M]`` schedule (a static
    one expanded)."""
    sched = scenario_schedule(scenario.schedule_kind, topology, num_ticks, seed=seed,
                              churn_prob=scenario.churn_prob)
    if sched is None:
        sched = static_schedule(topology, num_ticks)
    return sched
