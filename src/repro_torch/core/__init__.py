"""Core BRIDGE library of the port: graphs, attacks, screening, trainer,
the ByRDiE and BRDSO baselines, and the sharded gossip over a mesh."""
from repro_torch.core.brdso import BrdsoConfig, BrdsoState, BrdsoTrainer
from repro_torch.core.bridge import BridgeConfig, BridgeState, BridgeTrainer, replicate, stack_flatten
from repro_torch.core.byrdie import ByrdieConfig, ByrdieState, ByrdieTrainer
from repro_torch.core.byzantine import ATTACKS, get_attack, pick_byzantine_mask
from repro_torch.core.gossip import coordwise_gossip_leaf, gossip_screen_params, vector_rule_select
from repro_torch.core.graph import Topology, check_assumption4, complete_graph, erdos_renyi, small_world
from repro_torch.core.neighbors import NeighborTable
from repro_torch.core.screening import RULES, min_neighbors, screen_all, screen_gathered

__all__ = [
    "BrdsoConfig", "BrdsoState", "BrdsoTrainer", "ByrdieConfig", "ByrdieState", "ByrdieTrainer",
    "BridgeConfig", "BridgeState", "BridgeTrainer", "replicate", "stack_flatten",
    "ATTACKS", "get_attack", "pick_byzantine_mask",
    "Topology", "check_assumption4", "complete_graph", "erdos_renyi", "small_world",
    "coordwise_gossip_leaf", "gossip_screen_params", "vector_rule_select",
    "NeighborTable",
    "RULES", "min_neighbors", "screen_all", "screen_gathered",
]
