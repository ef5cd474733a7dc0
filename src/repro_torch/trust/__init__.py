"""repro_torch.trust — reputation-weighted screening and the equivocation
echo protocol (port of `repro.trust`).

The trace's suspicion statistic (per-edge trim fractions, from the
screening rules' decision twins) drives a carried ``[M, W]`` reputation
state: reputation weights for the ``rep_*`` rules, and an eviction latch
that clears a confirmed attacker's edge from the screening mask.  On the
network runtime a commit-then-gossip echo protocol surfaces equivocation
as quorum-confirmed digest mismatches.  Off by default (``trust=None``) and
bit-inert until it acts; see `repro_torch.trust.reputation`.
"""
from repro_torch.trust import echo
from repro_torch.trust.reputation import (TrustSpec, TrustState, accumulate_trim, edge_weights,
                                          init_state, summarize, update)

__all__ = ["TrustSpec", "TrustState", "accumulate_trim", "edge_weights", "init_state",
           "summarize", "update", "echo"]
