"""The trace's forensics-free half: bounded-memory aggregates carried
through a run (port of `repro.obs.trace`).

A `TraceSpec` on `BridgeConfig.trace` or `GridEngine(trace=)` adds the
``bridge.obs`` stage to every tick, which reads the tick's honest
``loss`` and ``consensus_dist`` and folds them into a `TraceState`:

* **a loss trace** — the last tick's honest loss, or its EMA;
* **a strided raw-trace reservoir** — ``reservoir`` slots of (tick, loss),
  written every ``stride`` ticks, overwriting round-robin;
* **a divergence sentinel** — the first tick at which the honest loss or
  the consensus distance went non-finite (``first_bad``, -1 while finite),
  which `repro_torch.adversary.breakdown` reports per probe and the grid
  engine emits as an ``obs.divergence`` event.

The stage only reads the step's metrics, so a traced run's parameters,
keys and carries equal the untraced run's bit for bit.

The forensics half (``forensics=True``: per-edge trim counters, survival
rates, staleness and wire-bits histograms) reads the screening rules'
``*_with_decisions`` twins, which the port does not have yet; such a spec
raises (ROADMAP Queue 1 open item 5).  `TraceState` keeps the reference's
fields all the same, the forensic ones zero-sized, so a reference state
crosses over field by field (`repro_torch.convert`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ref

FORENSICS = ("TraceSpec(forensics=True): the per-edge trim counters read the screening "
             "rules' *_with_decisions twins, ROADMAP Queue 1 open item 5; pass "
             "TraceSpec(forensics=False)")


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """What the step traces (the reference's fields and defaults; frozen
    and hashable)."""

    # per-edge trim counters + survival rates + histograms: not ported
    # (FORENSICS); the default stays the reference's
    forensics: bool = True
    decide_stride: int = 1
    # raw-trace reservoir slots (0 disables); slot i holds the (tick, loss)
    # of the latest tick with t % stride == 0, written round-robin
    reservoir: int = 0
    stride: int = 1
    hist_bins: int = 16
    stale_max: int = 32
    # loss_trace smoothing: 0 keeps the last tick's loss, else the EMA
    # weight on the carried value
    ema: float = 0.0
    # first-non-finite-tick sentinel on (loss, consensus_dist)
    sentinel: bool = True

    def __post_init__(self):
        if (self.reservoir < 0 or self.stride < 1 or self.hist_bins < 1
                or self.decide_stride < 1):
            raise ValueError(f"invalid TraceSpec: {self}")


class TraceState(NamedTuple):
    """The carried aggregates (one per cell; a grid stacks a leading
    ``[E]``), the reference's fields in its order."""

    edge_seen: torch.Tensor  # [0, 0]: forensics only
    edge_trim: torch.Tensor  # [0, 0]
    byz_seen: torch.Tensor  # f32 scalar, forensics only
    byz_trim: torch.Tensor
    hon_seen: torch.Tensor
    hon_trim: torch.Tensor
    stale_hist: torch.Tensor  # [hist_bins] f32, forensics only
    bits_hist: torch.Tensor  # [hist_bins] f32, forensics only
    loss_trace: torch.Tensor  # f32 scalar (last or EMA, per spec.ema)
    res_tick: torch.Tensor  # [R] int32, -1 = slot never written
    res_loss: torch.Tensor  # [R] f32
    res_trim: torch.Tensor  # [R, 0, 0]: forensics only
    first_bad: torch.Tensor  # int32 scalar, -1 = finite so far


def check(spec: TraceSpec | None) -> None:
    """Refuse what the port cannot trace yet (`FORENSICS`)."""
    if spec is not None and spec.forensics:
        raise ValueError(FORENSICS)


def init_state(spec: TraceSpec | None, *, lead: tuple = (),
               device: str | torch.device) -> TraceState | None:
    """Fresh aggregates for one cell (``lead=(E,)`` stacks a grid's worth)
    on ``device``; None when ``spec`` is None.  The forensic ``[M, W]``
    fields stay zero-sized, so the reference's M and W are not taken."""
    if spec is None:
        return None
    check(spec)
    r = spec.reservoir
    z = lambda shape: torch.zeros(lead + shape, dtype=torch.float32, device=device)
    return TraceState(
        edge_seen=z((0, 0)), edge_trim=z((0, 0)),
        byz_seen=z(()), byz_trim=z(()), hon_seen=z(()), hon_trim=z(()),
        stale_hist=z((spec.hist_bins,)), bits_hist=z((spec.hist_bins,)),
        loss_trace=z(()),
        res_tick=torch.full(lead + (r,), -1, dtype=torch.int32, device=device),
        res_loss=z((r,)),
        res_trim=z((r, 0, 0)),
        first_bad=torch.full(lead, -1, dtype=torch.int32, device=device),
    )


def update(spec: TraceSpec, st: TraceState, *, t: int, loss: torch.Tensor,
           consensus: torch.Tensor) -> TraceState:
    """Fold tick ``t`` (a host int) into the aggregates: ``loss`` and
    ``consensus`` are the tick's honest loss and consensus distance, one a
    cell (``[E]``, or 0-d).  Returns a new state; ``st`` is not written."""
    kw: dict[str, Any] = {}
    loss32 = loss.to(torch.float32)
    if spec.ema > 0.0:
        # XLA contracts the reference's ema * trace + (1 - ema) * loss into
        # one fused multiply-add on the first product
        kw["loss_trace"] = (loss32.clone() if t == 0 else
                            ref.fma_f32(st.loss_trace, float(np.float32(spec.ema)),
                                        loss32 * np.float32(1.0 - spec.ema)))
    else:
        kw["loss_trace"] = loss32
    if spec.reservoir > 0 and t % spec.stride == 0:
        slot = (t // spec.stride) % spec.reservoir
        res_tick, res_loss = st.res_tick.clone(), st.res_loss.clone()
        res_tick[..., slot] = t
        res_loss[..., slot] = loss32
        kw["res_tick"], kw["res_loss"] = res_tick, res_loss
    if spec.sentinel:
        bad = ~(torch.isfinite(loss32) & torch.isfinite(consensus.to(torch.float32)))
        kw["first_bad"] = torch.where((st.first_bad < 0) & bad,
                                      torch.full_like(st.first_bad, t), st.first_bad)
    return st._replace(**kw)


def summarize(spec: TraceSpec, state: TraceState, **_unused) -> dict:
    """One cell's aggregates as a JSON-ready record: the spec, the sentinel
    tick, the loss trace and (with a reservoir) its written slots — the
    reference's ``summarize`` less the forensic fields."""
    check(spec)
    out: dict[str, Any] = {"spec": dataclasses.asdict(spec)}
    fb = int(state.first_bad)
    out["first_bad_tick"] = None if fb < 0 else fb
    out["loss_trace"] = float(state.loss_trace)
    if spec.reservoir > 0:
        ticks = state.res_tick.cpu().numpy()
        live = ticks >= 0
        out["reservoir"] = {
            "ticks": [int(x) for x in ticks[live]],
            "loss": [float(x) for x in state.res_loss.cpu().numpy()[live]],
        }
    return out
