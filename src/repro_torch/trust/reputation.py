"""Reputation-weighted screening: the carried per-edge trust state (port of
`repro.trust.reputation`).

BRIDGE screens values but never identifies attackers.  This layer turns
the trace's suspicion statistic into action:

* **suspicion** ``[M, W]`` — an EMA over each tick's evidence: the trim
  fraction each live in-edge contributed (the screening rules' decision
  twins, `repro_torch.core.screening.RULES_WITH_DECISIONS`), centered per
  receiver, plus the echo protocol's equivocation evidence
  (`repro_torch.trust.echo`) on the network runtime;
* **reputation weights** — ``clip(1 - suspicion, 0, 1)``, which the
  ``rep_trimmed_mean`` / ``rep_median`` rules take (`edge_weights`);
* **eviction** — once suspicion exceeds ``evict_threshold`` (after
  ``warmup`` ticks) the edge's mask bit is cleared for the rest of the run,
  as if the link had died.

``trust=None`` (the default everywhere) keeps every step's trust-free
program; a spec on but unable to act (a plain rule, ``warmup`` past the
horizon) leaves the trajectory bit for bit the trust-free one.

The reference's caveats hold: honest edges are trimmed too (about 2b/n of
coordinates under the trimmed mean, nearly all under the median), so the
trim evidence is centered per receiver, ``relu(trim - mean over live
in-edges)``; per-edge lossy codecs make honest digests differ (raise
``echo_tol``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.obs.trace import ranking_auc


@dataclasses.dataclass(frozen=True)
class TrustSpec:
    """What the step distrusts (the reference's fields and defaults; frozen
    and hashable)."""

    # suspicion EMA: s' = decay * s + (1 - decay) * evidence, on live edges
    decay: float = 0.9
    # evidence = trim_weight * relu(trim - receiver's live mean)
    #          + echo_weight * echo evidence (0 / 1 a confirmed quorum)
    trim_weight: float = 1.0
    echo_weight: float = 4.0
    # eviction latch: suspicion > evict_threshold once t >= warmup
    evict_threshold: float = 0.5
    warmup: int = 8
    # the commit-then-gossip echo protocol (the network runtime only: the
    # broadcast path has one payload a sender, so no equivocation)
    echo: bool = True
    # random-projection digest width q
    digest_dim: int = 4
    # relative tolerance of the digest comparison
    echo_tol: float = 1e-3
    # coordinate subsampling of the trim-membership pass, as TraceSpec's
    decide_stride: int = 1

    def __post_init__(self):
        if (not 0.0 <= self.decay < 1.0 or self.trim_weight < 0.0
                or self.echo_weight < 0.0 or not 0.0 < self.evict_threshold <= 1.0
                or self.warmup < 0 or self.digest_dim < 1 or self.echo_tol < 0.0
                or self.decide_stride < 1):
            raise ValueError(f"invalid TrustSpec: {self}")


class TrustState(NamedTuple):
    """The carried trust state (one per cell; a grid stacks a leading
    ``[E]``); ``W`` the per-node edge slots: M dense, K on the table."""

    suspicion: torch.Tensor  # [M, W] f32 evidence EMA in [0, 1]
    evicted: torch.Tensor  # [M, W] bool latched eviction bits
    echo_mism: torch.Tensor  # [M, W] f32 accumulated confirmed-equivocation counts


def init_state(spec: TrustSpec | None, num_nodes: int, width: int, *, lead: tuple = (),
               device: str | torch.device) -> TrustState | None:
    """A fresh all-trusting state for one cell (``lead=(E,)`` stacks a
    grid's worth) on ``device``: suspicion 0, weight 1, nothing evicted;
    None when ``spec`` is None."""
    if spec is None:
        return None
    mw = lead + (num_nodes, width)
    return TrustState(
        suspicion=torch.zeros(mw, dtype=torch.float32, device=device),
        evicted=torch.zeros(mw, dtype=torch.bool, device=device),
        echo_mism=torch.zeros(mw, dtype=torch.float32, device=device),
    )


def edge_weights(spec: TrustSpec, st: TrustState) -> torch.Tensor:
    """``[.., M, W]`` reputation weights for the reputation-aware rules:
    ``clip(1 - suspicion, 0, 1)``, 0 on evicted edges."""
    w = torch.clamp(1.0 - st.suspicion, 0.0, 1.0)
    return torch.where(st.evicted, 0.0, w)


def accumulate_trim(acc: torch.Tensor, trim_blk: torch.Tensor, frac: float) -> torch.Tensor:
    """One coordinate block's ``[M, W]`` trim fractions folded into a
    tick's evidence accumulator with the block's static weight ``frac`` (its
    share of d), the reference's streaming fold; one block (``frac`` 1.0)
    is the identity."""
    return acc + trim_blk * frac


def update(spec: TrustSpec, st: TrustState, *, t: int, trim_frac: torch.Tensor,
           live: torch.Tensor, echo_evidence: torch.Tensor | None = None) -> TrustState:
    """Fold one tick of evidence into the state: ``trim_frac`` / ``live``
    the tick's ``[.., M, W]`` trim fractions (zero outside ``live``) and
    live-edge mask, ``echo_evidence`` the 0 / 1 confirmed-equivocation
    matrix (None on the synchronous path); ``t`` the host tick.  Returns a
    new state."""
    kw: dict[str, Any] = {}
    live_f = live.to(torch.float32)
    trim32 = trim_frac.to(torch.float32)
    # centered evidence: only trimming above the receiver's live mean counts
    center = (torch.sum(trim32 * live_f, dim=-1, keepdim=True)
              / torch.clamp(torch.sum(live_f, dim=-1, keepdim=True), min=1.0))
    ev = np.float32(spec.trim_weight) * torch.clamp(trim32 - center, min=0.0)
    if echo_evidence is not None:
        ev = ev + np.float32(spec.echo_weight) * echo_evidence.to(torch.float32)
        kw["echo_mism"] = st.echo_mism + echo_evidence
    # XLA contracts the reference's decay * s + (1 - decay) * ev into one
    # fused multiply-add on the first product
    susp = torch.clamp(ref.fma_f32(st.suspicion, float(np.float32(spec.decay)),
                                   np.float32(1.0 - spec.decay) * ev), 0.0, 1.0)
    susp = torch.where(live.bool(), susp, st.suspicion)
    kw["suspicion"] = susp
    kw["evicted"] = st.evicted | ((t >= spec.warmup) & (susp > spec.evict_threshold))
    return st._replace(**kw)


def summarize(spec: TrustSpec, state: TrustState, *, byz_mask=None,
              senders: np.ndarray | None = None) -> dict:
    """One cell's trust state as a JSON-ready record (the reference's):
    eviction counts split honest against Byzantine by the known mask (the
    honest receivers' view of their in-edges), and the AUC of the suspicion
    ranking Byzantine in-edges."""
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    susp = host(state.suspicion).astype(np.float64)
    evicted = host(state.evicted).astype(bool)
    mism = host(state.echo_mism).astype(np.float64)
    out: dict[str, Any] = {
        "spec": dataclasses.asdict(spec),
        "edges_evicted": int(evicted.sum()),
        "echo_mismatch_total": float(mism.sum()),
        "max_suspicion": float(susp.max()) if susp.size else 0.0,
    }
    if senders is not None and byz_mask is not None:
        byz = host(byz_mask).astype(bool)
        recv, slot = np.nonzero(senders >= 0)
        send = senders[recv, slot]
        keep = ~byz[recv]
        recv, slot, send = recv[keep], slot[keep], send[keep]
        byz_edge = byz[send]
        ev = evicted[recv, slot]
        out["byz_edges"] = int(byz_edge.sum())
        out["honest_edges"] = int((~byz_edge).sum())
        out["byz_evicted"] = int(ev[byz_edge].sum())
        out["honest_evicted"] = int(ev[~byz_edge].sum())
        out["honest_eviction_rate"] = float(ev[~byz_edge].mean()) if (~byz_edge).any() else 0.0
        out["byz_eviction_rate"] = float(ev[byz_edge].mean()) if byz_edge.any() else 0.0
        out["auc_byzantine_edges"] = ranking_auc(susp[recv, slot], byz_edge)
    return out
