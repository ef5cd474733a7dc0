"""In-run screening forensics and bounded-memory aggregates carried
through a run (port of `repro.obs.trace`).

A `TraceSpec` on `BridgeConfig.trace` or `GridEngine(trace=)` adds the
``bridge.obs`` stage to every tick, which folds the tick into a
`TraceState`:

* **per-edge trim counters** ``[M, W]`` (W = M dense, K sparse) — how often
  each live in-edge was seen and the trim fractions it accumulated, from
  the screening rules' decision twins (``forensics=True``, the reference's
  default; `repro_torch.core.screening.RULES_WITH_DECISIONS` through the
  decide form of the screening kernels);
* **Byzantine-vs-honest survival** — scalar totals against the known
  attacker mask;
* **staleness and wire-bits histograms** — fixed bins;
* **a loss trace** — the last tick's honest loss, or its EMA;
* **a strided raw-trace reservoir** — ``reservoir`` slots of (tick, loss,
  trim matrix), written every ``stride`` ticks, round-robin;
* **a divergence sentinel** — the first tick at which the honest loss or
  the consensus distance went non-finite (``first_bad``, -1 while finite).

The stage only reads the tick: the decide forms return the plain screens'
output bit for bit, so a traced run's parameters, keys and carries equal
the untraced run's.

The scalar survival sums (``byz_trim``, ``hon_trim``) are ``torch.sum``
over ``[M, W]``: equal to the reference's wherever the sums are exact
(fractions over a power-of-two number of columns), else within a few ulps
(XLA sums in its own order; ROADMAP Queue 3).  Counters are float32, exact
to 2**24 observations.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ref


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """What the step traces (the reference's fields and defaults; frozen
    and hashable)."""

    # per-edge trim counters + survival rates + histograms (the screening
    # rules' decision twins)
    forensics: bool = True
    # coordinate subsampling for the per-edge membership pass: fractions
    # over every decide_stride-th coordinate (1 = exact); y stays exact
    decide_stride: int = 1
    # raw-trace reservoir slots (0 disables); slot i holds the (tick, loss,
    # trim matrix) of the latest tick with t % stride == 0, round-robin
    reservoir: int = 0
    stride: int = 1
    # fixed histogram bins (staleness in ticks, wire bits as a fraction of
    # the uncompressed 32 d payload)
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

    edge_seen: torch.Tensor  # [M, W] f32 live-edge observation counts
    edge_trim: torch.Tensor  # [M, W] f32 accumulated trim fractions
    byz_seen: torch.Tensor  # f32 scalar
    byz_trim: torch.Tensor
    hon_seen: torch.Tensor
    hon_trim: torch.Tensor
    stale_hist: torch.Tensor  # [hist_bins] f32
    bits_hist: torch.Tensor  # [hist_bins] f32
    loss_trace: torch.Tensor  # f32 scalar (last or EMA, per spec.ema)
    res_tick: torch.Tensor  # [R] int32, -1 = slot never written
    res_loss: torch.Tensor  # [R] f32
    res_trim: torch.Tensor  # [R, M, W] f32 (R or M, W zero-sized when off)
    first_bad: torch.Tensor  # int32 scalar, -1 = finite so far


def init_state(spec: TraceSpec | None, num_nodes: int = 0, width: int = 0, *,
               lead: tuple = (), device: str | torch.device) -> TraceState | None:
    """Fresh aggregates for one cell (``lead=(E,)`` stacks a grid's worth)
    on ``device``; None when ``spec`` is None.  ``width`` is the per-node
    edge-slot count: M dense, K on the neighbor table; without forensics
    the ``[M, W]`` fields are zero-sized."""
    if spec is None:
        return None
    mw = (num_nodes, width) if spec.forensics else (0, 0)
    r = spec.reservoir
    z = lambda shape: torch.zeros(lead + shape, dtype=torch.float32, device=device)
    return TraceState(
        edge_seen=z(mw), edge_trim=z(mw),
        byz_seen=z(()), byz_trim=z(()), hon_seen=z(()), hon_trim=z(()),
        stale_hist=z((spec.hist_bins,)), bits_hist=z((spec.hist_bins,)),
        loss_trace=z(()),
        res_tick=torch.full(lead + (r,), -1, dtype=torch.int32, device=device),
        res_loss=z((r,)),
        res_trim=z((r,) + mw),
        first_bad=torch.full(lead, -1, dtype=torch.int32, device=device),
    )


@functools.lru_cache(maxsize=64)
def _one_hot(bins: tuple, width: int, device: torch.device) -> torch.Tensor:
    """``[len(bins), width]`` float32 rows, 1 at each bin (made once per
    distinct tuple and device, so a tick copies nothing to the card)."""
    out = torch.zeros((len(bins), width), dtype=torch.float32)
    out[torch.arange(len(bins)), torch.as_tensor(bins)] = 1.0
    return out.to(device)


def _hist_add(hist: torch.Tensor, bins: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``hist [.., H]`` plus ``weights`` summed into ``bins`` (int64 of
    weights' shape ``[.., n]``), cell by cell (the reference's
    ``segment_sum`` / ``.at[].add``)."""
    h = hist.shape[-1]
    lead = hist.shape[:-1]
    cells = int(np.prod(lead)) if lead else 1
    offs = (torch.arange(cells, device=hist.device) * h).reshape(*lead, 1) if lead else 0
    flat = hist.reshape(-1).clone()
    flat.index_add_(0, (bins + offs).reshape(-1), weights.reshape(-1).to(flat.dtype))
    return flat.reshape(hist.shape)


def update(spec: TraceSpec, st: TraceState, *, t: int, loss: torch.Tensor,
           consensus: torch.Tensor, trim_frac: torch.Tensor | None = None,
           live: torch.Tensor | None = None, byz_edge: torch.Tensor | None = None,
           staleness: torch.Tensor | None = None, wire_bits=None, live_edges=None,
           d: int | None = None) -> TraceState:
    """Fold tick ``t`` (a host int) into the aggregates: ``loss`` and
    ``consensus`` are the tick's honest loss and consensus distance, one a
    cell (``[E]``, or 0-d); ``trim_frac`` / ``live`` / ``byz_edge`` the
    tick's ``[.., M, W]`` trim fractions (zero outside ``live``), live-edge
    mask and Byzantine-sender mask; ``staleness`` the delivered messages'
    ages ``[.., M, W]`` (None on the synchronous path); ``wire_bits`` the
    per-edge codeword size (an int, or a tuple of one a cell) and
    ``live_edges`` the tick's live-edge count (a float or ``[E]``).
    Returns a new state; ``st`` is not written."""
    kw: dict[str, Any] = {}
    loss32 = loss.to(torch.float32)
    forensic = spec.forensics and trim_frac is not None
    if forensic:
        live_f = live.to(torch.float32)
        byz_f = byz_edge.to(torch.float32)
        total = lambda x: torch.sum(x, dim=(-2, -1))
        kw["edge_seen"] = st.edge_seen + live_f
        kw["edge_trim"] = st.edge_trim + trim_frac
        kw["byz_seen"] = st.byz_seen + total(live_f * byz_f)
        kw["byz_trim"] = st.byz_trim + total(trim_frac * byz_f)
        kw["hon_seen"] = st.hon_seen + total(live_f * (1.0 - byz_f))
        kw["hon_trim"] = st.hon_trim + total(trim_frac * (1.0 - byz_f))
        if staleness is not None:
            bin_w = max(1, -(-spec.stale_max // spec.hist_bins))
            bins = torch.clamp(torch.div(staleness.to(torch.int64), bin_w, rounding_mode="floor"),
                               0, spec.hist_bins - 1)
            lead = st.stale_hist.shape[:-1]
            kw["stale_hist"] = _hist_add(st.stale_hist, bins.reshape(*lead, -1),
                                         live_f.expand(bins.shape).reshape(*lead, -1))
        if wire_bits is not None and d is not None:
            # bits binned as a fraction of the uncompressed 32 d payload
            lead = st.bits_hist.shape[:-1]
            bits = np.broadcast_to(np.asarray(wire_bits, np.int64), lead)
            frac_bin = np.clip(bits * spec.hist_bins // (32 * d + 1), 0, spec.hist_bins - 1)
            onehot = _one_hot(tuple(frac_bin.reshape(-1).tolist()), spec.hist_bins,
                              st.bits_hist.device).reshape(st.bits_hist.shape)
            le = 1.0 if live_edges is None else live_edges
            if isinstance(le, torch.Tensor):
                le = le.to(torch.float32).expand(lead)[..., None]
            kw["bits_hist"] = st.bits_hist + onehot * le
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
        if forensic:
            res_trim = st.res_trim.clone()
            res_trim[..., slot, :, :] = trim_frac
            kw["res_trim"] = res_trim
    if spec.sentinel:
        bad = ~(torch.isfinite(loss32) & torch.isfinite(consensus.to(torch.float32)))
        kw["first_bad"] = torch.where((st.first_bad < 0) & bad,
                                      torch.full_like(st.first_bad, t), st.first_bad)
    return st._replace(**kw)


# The metric key of the chunk-streaming step's per-block trim fractions
# (`repro_torch.stream`): one ``[NB]`` vector a tick, each coordinate
# block's live-edge-mean trim fraction in global block order, beside the
# scalar ``obs_trim_frac`` (a layer whose block trims everything while the
# others stay quiet is a localized attack the scalar would dilute).
BLOCK_TRIM_STREAM = "stream_block_trim_frac"


def staleness_of(net, t: int) -> torch.Tensor | None:
    """The delivered messages' ages ``[.., M, W]`` of a mailbox state (duck
    typed on ``send_tick``; 0 where nothing arrived yet), or None when the
    runtime carries none."""
    if getattr(net, "send_tick", None) is None:
        return None
    from repro_torch.net import mailbox as mb  # the net package imports the trainer

    return torch.where(net.send_tick > mb.NEVER, t - net.send_tick, 0)


def obs_trim_frac(trim: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The ``obs_trim_frac`` metric: the live edges' mean trim fraction of
    the tick, one a cell (``trim``, ``live`` ``[.., M, W]``)."""
    live_f = live.to(torch.float32)
    return (torch.sum(trim * live_f, dim=(-2, -1))
            / torch.clamp(torch.sum(live_f, dim=(-2, -1)), min=1.0))


# ---------------------------------------------------------------------------
# Host-side summaries (report inputs)
# ---------------------------------------------------------------------------


def sender_grid(num_nodes: int, *, adjacency=None, neighbors=None) -> np.ndarray:
    """``[M, W]`` sender node id per edge slot (-1 = never a live edge):
    a neighbor table maps slots through its indices and valid mask; dense
    layouts map slot i to sender i, masked by the adjacency when the slot
    set is static (the synchronous broadcast)."""
    if neighbors is not None:
        return np.where(np.asarray(neighbors.valid), np.asarray(neighbors.idx, np.int64), -1)
    grid = np.broadcast_to(np.arange(num_nodes, dtype=np.int64)[None, :], (num_nodes, num_nodes))
    if adjacency is None:
        return grid.copy()
    return np.where(np.asarray(adjacency, bool), grid, -1)


def ranking_auc(scores, labels) -> float | None:
    """Mann-Whitney AUC (average ranks on ties) of ``scores`` ranking
    ``labels`` (True = positive class); None when a class is empty."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    labels = np.asarray(labels, bool).reshape(-1)
    npos = int(labels.sum())
    nneg = int(labels.size - npos)
    if npos == 0 or nneg == 0:
        return None
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    r = np.empty(s.size, np.float64)
    i = 0
    while i < s.size:
        j = i
        while j + 1 < s.size and s[j + 1] == s[i]:
            j += 1
        r[i:j + 1] = 0.5 * (i + j) + 1.0  # average 1-based rank of the tie run
        i = j + 1
    ranks = np.empty(s.size, np.float64)
    ranks[order] = r
    return float((ranks[labels].sum() - npos * (npos + 1) / 2.0) / (npos * nneg))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize(spec: TraceSpec, state: TraceState, *, byz_mask=None,
              senders: np.ndarray | None = None, top: int = 20) -> dict:
    """One cell's aggregates as a JSON-ready forensics record (the
    reference's): the sentinel tick, the loss trace, the survival rates and
    histograms, the suspicion-ranked edges and, with the true Byzantine
    mask, the AUC of the trim frequencies ranking Byzantine in-edges (the
    honest receivers' view)."""
    out: dict[str, Any] = {"spec": dataclasses.asdict(spec)}
    fb = int(_host(state.first_bad))
    out["first_bad_tick"] = None if fb < 0 else fb
    out["loss_trace"] = float(_host(state.loss_trace))
    byz = None if byz_mask is None else _host(byz_mask).astype(bool)
    if spec.forensics and state.edge_seen.numel():
        seen = _host(state.edge_seen).astype(np.float64)
        trim = _host(state.edge_trim).astype(np.float64)
        freq = trim / np.maximum(seen, 1.0)
        bs = float(_host(state.byz_seen))
        ht = float(_host(state.hon_seen))
        out["survival"] = {
            "byz_edges_seen": bs,
            "byz_trim_freq": float(_host(state.byz_trim)) / max(bs, 1.0),
            "honest_edges_seen": ht,
            "honest_trim_freq": float(_host(state.hon_trim)) / max(ht, 1.0),
        }
        out["stale_hist"] = [float(x) for x in _host(state.stale_hist)]
        out["bits_hist"] = [float(x) for x in _host(state.bits_hist)]
        if senders is not None:
            recv, slot = np.nonzero((seen > 0) & (senders >= 0))
            send = senders[recv, slot]
            if byz is not None:
                keep = ~byz[recv]  # forensics are the honest nodes' view of their in-edges
                recv, slot, send = recv[keep], slot[keep], send[keep]
            f = freq[recv, slot]
            order = np.argsort(-f, kind="mergesort")[:top]
            out["top_edges"] = [
                {"receiver": int(recv[k]), "sender": int(send[k]),
                 "trim_freq": float(f[k]), "seen": float(seen[recv[k], slot[k]]),
                 "byzantine": None if byz is None else bool(byz[send[k]])}
                for k in order
            ]
            if byz is not None:
                out["auc_byzantine_edges"] = ranking_auc(f, byz[send])
    if spec.reservoir > 0:
        ticks = _host(state.res_tick)
        live = ticks >= 0
        out["reservoir"] = {
            "ticks": [int(x) for x in ticks[live]],
            "loss": [float(x) for x in _host(state.res_loss)[live]],
        }
    return out
