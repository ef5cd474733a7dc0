"""The BRIDGE trainer — Algorithm 1 of the paper; port of
`repro.core.bridge` (``build_cell_step`` and ``build_cell_runtime_step``
with their rule, attack, adversary and codec banks, the trace, the trust
layer and the live metric ring, driven by ``BridgeTrainer``), on the dense
or the sparse ``[M, K]`` layout.

All M node replicas live on one device as a stacked ``[M, ...]`` parameter
dict.  One tick, after ``key, sub = split(state.key)``:

1. **attack** — Byzantine rows of the broadcast ``w [M, d]`` are substituted
   (`repro_torch.core.byzantine`, keyed by ``sub``);
1b. **adversary** — an adaptive adversary (`repro_torch.adversary`) observes
   the honest rows, advances its carried state (``state.adv``) and
   re-crafts the Byzantine rows under ``fold_in(sub, ADV_SALT)``;
   ``inner_max`` ascends through the cell's own screen (the kernels under
   autograd, `repro_torch.kernels.autograd`); ``none`` skips the stage;
2. **codec** — every sender's value (a lossy codec: its delta) is encoded
   under ``fold_in(sub, COMM_SALT)``, a wire attack corrupts the Byzantine
   senders' codewords under ``fold_in(sub, WIRE_SALT)``, and receivers
   decode with the carry (`repro_torch.comm.exchange`); the identity codec
   with no wire attack skips the stage;
3. **screen** — every node screens what it received from its in-neighbors,
   with its own (never encoded) broadcast value as self: `screening.screen_all`
   under the ``[M, M]`` adjacency, or `screening.screen_gathered` through a
   `NeighborTable` when ``sparse``, by any rule of `screening.RULES`.  On the
   card BRIDGE-T and BRIDGE-M run the screening kernels, BRIDGE-K and
   BRIDGE-B the pairwise-distance kernel once a tick (Bulyan then the
   trimmed-mean kernel over its selection); DGD's ``mean``, ``geomedian``,
   ``clipped_mean`` and the ``rep_*`` rules are plain PyTorch;
4. **apply** — ``w_j <- y_j - rho(t) * grad f_j(w_j)`` with
   ``rho(t) = 1 / (lam (t0 + t))``, ``rho * g`` rounded to float32 before the
   subtract as in the reference;
5. **obs** — with a `repro_torch.obs.TraceSpec` (``BridgeConfig.trace``),
   the tick folds into the carried `TraceState` (``state.obs``): with
   forensics the screen runs its decide form (the screening rules'
   decision twins, `screening.screen_all_decide_banked` and its siblings:
   the plain output bit for bit, plus the ``[M, W]`` per-edge trim
   fractions), whose fractions feed the per-edge counters and survival
   sums; the loss trace, reservoir and sentinel read the metrics.  The
   trajectory is bit for bit the untraced one;
6. **trust** — with a `repro_torch.trust.TrustSpec` (``BridgeConfig.trust``)
   the screen always decides: the carried `TrustState` (``state.trust``)
   gives the ``rep_*`` rules their reputation weights and clears evicted
   edges from the mask, and the ``bridge.trust`` stage folds the tick's
   trim fractions into it.  On the runtime the ``bridge.echo`` stage first
   digests each node's views under ``fold_in(sub, TRUST_SALT)``, lets
   ``slander``'s nodes forge the rows they gossip, and cross-checks the
   digests for equivocation (`repro_torch.trust.echo`);
7. **metrics** — with a `repro_torch.obs.MetricSpec` (``BridgeConfig.metrics``)
   the tick's scalars (the metrics above, the honest-mean gradient norm,
   the trace's trim fraction, trust's evicted share, on the runtime the
   delivered messages' age quantiles) fold into the carried ring
   (``state.mets``) on the device; bit-inert.

Past ``BridgeConfig.screen_chunk`` coordinates the plain rules screen node
by node and chunk by chunk, as the reference does (`screening._streams`);
the kernel rules run whole, which is the same result.

Every random number comes from the reference's Threefry streams
(`repro_torch.prng`), so a seeded run follows the seeded reference run.

With ``runtime=`` (`repro_torch.net`) the tick is the reference's
network-runtime iteration (`build_cell_runtime_step`): the attack crafts
per-link messages (`byzantine.MessageAttack`), an adversary re-crafts the
Byzantine senders' links (its message form), a lossy codec encodes each
link under its own keys ``fold_in(key, edge_id)`` with an ``[M, W, d]``
carry that advances on the tick's live edges only, the runtime moves the
messages (``exchange``), every node screens its mailbox views with
`screening.screen_views_banked` (the views kernels on the card), and a
node with fewer usable views than its rule's Table-II minimum keeps its
own value.

Both ticks are the reference's cell steps: `build_cell_step` (synchronous)
and `build_cell_runtime_step` (through a runtime) take stacked cells
(`CellParams`: rule, attack, codec and adversary chosen from static
banks, ``b``, the Byzantine masks, the adversary's hyperparameters and the
step-size schedule per cell, on a net grid the scenario) and state
``[E, M, ...]`` (the codec carry ``[E, M, d]`` or per link ``[E, M, W,
d]``, the adversary's ``[E, d]``), and `BridgeTrainer.step` is their E = 1
call with the trainer's one constant cell.  The batched grids
(`repro_torch.sim.engine`) run the same steps over many cells: every
screening kernel then launches once a tick for all of them, and a lossy
dense codec decodes every cell's rows in one ``dequant_carry`` launch.

PyTorch runs eagerly, so the reference's ``jit``/``scan`` machinery has no
counterpart: `BridgeTrainer.run` is a Python loop over `BridgeTrainer.step`,
and `BridgeTrainer.run_chunks` one over chunks of ticks (no synchronize
inside a chunk), the metric ring handed to a `repro_torch.obs.MetricWriter`
after each.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.adversary import protocols as adv_lib
from repro_torch.analysis.contracts import Contract
from repro_torch.comm import codec as codec_lib
from repro_torch.comm import exchange
from repro_torch.core import byzantine, screening
from repro_torch.core.graph import Topology
from repro_torch.core.neighbors import NeighborTable, edge_id_grid
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.trust import echo as echo_lib
from repro_torch.trust import reputation as trust_lib

Params = dict[str, torch.Tensor]

# Salts decorrelating the streams folded from one tick's subkey (the
# reference's `repro.core.bridge` constants).
NET_SALT = 0x6E657430
COMM_SALT = 0x636D6D30
WIRE_SALT = 0x77697230
ADV_SALT = 0x61647630
TRUST_SALT = 0x74727530

class BridgeState(NamedTuple):
    params: Params  # leaves with leading node axis [M, ...]
    t: int  # iteration counter
    key: np.ndarray  # Threefry key, two uint32 words (repro_torch.prng)
    # codec carry: [M, d] per sender on the broadcast path, [M, W, d] per
    # link on the runtime path; None for a lossless codec
    comm: exchange.CommState | None = None
    net: Any = None  # the runtime's state (mailboxes); None when synchronous
    # the adversary's carried observations (adversary.AdvState): [d] rows
    # for a trainer, [E, d] for stacked cells; None when no adversary of
    # the bank is stateful
    adv: Any = None
    # the trace's aggregates (obs.TraceState, a leading [E] for stacked
    # cells); None when untraced
    obs: Any = None
    # the trust layer's state (trust.TrustState, [M, W] suspicion, evictions
    # and echo counts, a leading [E] for stacked cells); None when off
    trust: Any = None
    # the live metric ring (obs.MetricState, [C, S] and its count, a leading
    # [E] for stacked cells); None without a metrics spec
    mets: Any = None


def cell_step_size(lam, t0, lr, t: int):
    """rho(t) = lr if lr > 0 else 1 / (lam * (t0 + t)), in float32 (Sec. IV):
    a float for scalar settings, a float32 ``[E]`` array for the cells'
    ``[E]`` settings (each entry the scalar form's value)."""
    f32 = np.float32
    lam, t0, lr = (np.asarray(v, f32) for v in (lam, t0, lr))
    with np.errstate(divide="ignore", over="ignore"):
        rho = np.where(lr > 0, lr, f32(1.0) / (lam * (t0 + f32(t)))).astype(f32)
    return float(rho) if rho.ndim == 0 else rho


class CellParams(NamedTuple):
    """The switchable parameters of E stacked cells (the reference's
    ``CellParams`` rows): the rule, the attack, the codec and the adversary
    as indices into the step's static banks, the Byzantine bound, the
    adversary's ``[E, THETA_DIM]`` hyperparameters and the step-size
    schedule per cell, the ``[E, M]`` Byzantine masks on the device and, on
    a net grid, each cell's network scenario as an index into the runtime's
    bank.  Indices, bounds, thetas and schedules stay on the host, where
    they pick the banks' branches, the ascent's steps and the step size
    without reading the card.  An empty ``codec_idx`` or ``adv_idx`` is
    entry 0 for every cell.  ``metrics`` is the cells' one
    `repro_torch.obs.MetricSpec` (None: no metric ring), as the
    reference's field."""

    rule_idx: tuple[int, ...]
    attack_idx: tuple[int, ...]
    b: tuple[int, ...]
    byz_mask: torch.Tensor  # [E, M] bool
    lam: tuple[float, ...]
    t0: tuple[float, ...]
    lr: tuple[float, ...]
    scenario_idx: tuple[int, ...] = ()  # empty off a net grid
    codec_idx: tuple[int, ...] = ()  # empty: entry 0 for all
    adv_idx: tuple[int, ...] = ()  # empty: entry 0 for all
    adv_theta: np.ndarray | None = None  # [E, THETA_DIM] float32; None: the defaults
    metrics: Any = None  # the live metric ring's spec (obs.MetricSpec); None: off

    @property
    def num_cells(self) -> int:
        return len(self.b)

    def select(self, cells) -> CellParams:
        """The rows ``cells`` (host indices) of every field."""
        cells = [int(i) for i in cells]
        pick = lambda xs: tuple(xs[i] for i in cells) if xs else ()
        mask = self.byz_mask.index_select(0, torch.as_tensor(cells, device=self.byz_mask.device))
        return CellParams(pick(self.rule_idx), pick(self.attack_idx), pick(self.b), mask,
                          pick(self.lam), pick(self.t0), pick(self.lr), pick(self.scenario_idx),
                          pick(self.codec_idx), pick(self.adv_idx),
                          None if self.adv_theta is None else self.adv_theta[cells],
                          self.metrics)


@dataclasses.dataclass(frozen=True)
class BridgeConfig:
    """Graph, screening rule, threat model and step-size schedule of one
    trainer (the reference's fields for the main path)."""

    topology: Topology
    rule: str = "trimmed_mean"  # any of screening.RULES
    num_byzantine: int = 0  # the bound b given to the screening rule
    attack: str = "none"
    # adaptive adversary (repro_torch.adversary): none, ipm, alie_online,
    # dissensus, inner_max, equivocate, slander or a static attack's name;
    # it acts after `attack` (both substitute Byzantine rows: use one)
    adversary: str = "none"
    codec: str = "identity"  # wire codec (repro_torch.comm.codec.get_codec)
    byzantine_seed: int = 0
    lam: float = 1.0
    t0: float = 50.0
    lr: float = 0.0  # if > 0, a constant step size instead
    # coordinate streaming chunk: past it the plain rules screen node by
    # node and chunk by chunk (repro_torch.stream: the block width)
    screen_chunk: int | None = 1 << 20
    # neighbor-indexed [M, K] layout (repro_torch.core.neighbors): screening
    # reads each node's K table slots instead of masking all M rows
    sparse: bool = False
    # observability (repro_torch.obs.TraceSpec); None = untraced
    trace: Any = None
    # the trust layer (repro_torch.trust.TrustSpec); None = off.  Trust on
    # changes the trajectory once it acts (weights, evictions)
    trust: Any = None
    # the live metric ring (repro_torch.obs.MetricSpec); None = off.  Bit-inert;
    # `BridgeTrainer.run_chunks` flushes it to a MetricWriter after each chunk
    metrics: Any = None

    def step_size(self, t: int) -> float:
        return cell_step_size(self.lam, self.t0, self.lr, t)


def stack_batches(batch_fn: Callable[[int], Any], num_ticks: int, *,
                  device: str | torch.device = "cuda") -> Any:
    """``num_ticks`` batches stacked on a new leading axis, on ``device``:
    the reference's ``stack_batches``, the input of
    `repro_torch.net.AsyncBridgeTrainer.run_scan`.  A batch is a tensor or
    a tuple of them."""
    dev = resolve_device(device)
    batches = [batch_fn(i) for i in range(num_ticks)]
    if isinstance(batches[0], (tuple, list)):
        return tuple(torch.stack([torch.as_tensor(b[k]).to(dev) for b in batches])
                     for k in range(len(batches[0])))
    return torch.stack([torch.as_tensor(b).to(dev) for b in batches])


def stack_flatten(params: Params, lead: int = 1
                  ) -> tuple[torch.Tensor, Callable[[torch.Tensor], Params]]:
    """``[M, ...]`` parameter dict -> (``[M, D]`` float32 matrix, unflatten);
    with ``lead=2``, ``[E, M, ...]`` -> ``[E, M, D]`` (the grids' cells).

    Leaves are concatenated in sorted-key order, the reference's pytree leaf
    order (``b`` before ``w``); ``unflatten`` restores shapes and dtypes."""
    keys = sorted(params)
    head = tuple(params[keys[0]].shape[:lead])
    shapes = [params[k].shape[lead:] for k in keys]
    dtypes = [params[k].dtype for k in keys]
    sizes = [int(np.prod(s)) if len(s) else 1 for s in shapes]
    flat = torch.cat([params[k].reshape(*head, -1).to(torch.float32) for k in keys], dim=-1)

    def unflatten(w: torch.Tensor) -> Params:
        out, off = {}, 0
        for k, shape, size, dtype in zip(keys, shapes, sizes, dtypes, strict=True):
            out[k] = w[..., off:off + size].reshape((*head, *shape)).to(dtype)
            off += size
        return out

    return flat, unflatten


def replicate(params: Params, num_nodes: int, *, perturb: float = 0.0,
              key: np.ndarray | None = None) -> Params:
    """Stack one model into ``[M, ...]`` node replicas, optionally perturbed
    by ``perturb * normal(k_i)``, one key of ``split(key, n_leaves)`` per
    leaf in sorted key order (the reference's pytree order); ``key``
    defaults to ``PRNGKey(0)``, as there."""
    keys = sorted(params)
    if perturb > 0.0:
        leaf_keys = prng.split(prng.PRNGKey(0) if key is None else key, len(keys))
    out = {}
    for i, k in enumerate(keys):
        leaf = params[k]
        stacked = leaf[None].expand((num_nodes, *leaf.shape)).clone()
        if perturb > 0.0:
            # in place: a full-width leaf keeps two buffers, not four
            stacked.add_(prng.normal(leaf_keys[i], stacked.shape, stacked.device).mul_(perturb))
        out[k] = stacked
    return out


def cell_metrics(w_new: torch.Tensor, losses: torch.Tensor, honest: torch.Tensor, rho,
                 bits, live_edges, comm) -> dict:
    """The reference's diagnostics over the honest nodes of ``w_new``
    (``[M, d]``, or ``[E, M, d]`` with ``honest [E, M]``: one value a cell),
    with the codec's wire accounting over the live edges (``bits`` an int,
    or a tuple of E in a mixed codec bank) and the carry's residual
    norm."""
    cnt = torch.sum(honest, dim=-1).to(torch.float32)
    mu = torch.sum(torch.where(honest[..., None], w_new, 0.0), dim=-2) / cnt[..., None]
    dev = torch.where(honest[..., None], w_new - mu[..., None, :], 0.0)
    resid = 0.0
    if comm is not None:  # one norm a cell
        sq = comm.resid * comm.resid
        resid = torch.sqrt(torch.sum(sq.reshape(sq.shape[0], -1), dim=-1))
    if isinstance(bits, tuple):
        bits = np.asarray(bits, np.float32)
        total = (bits / np.float32(8.0) * live_edges if not isinstance(live_edges, torch.Tensor)
                 else torch.as_tensor(bits / np.float32(8.0), device=live_edges.device)
                 * live_edges)
    else:
        bits = float(bits)
        total = bits / 8.0 * live_edges
    return {
        "loss": torch.sum(torch.where(honest, losses, 0.0), dim=-1) / cnt,
        "consensus_dist": torch.sqrt(torch.amax(torch.sum(dev * dev, dim=-1), dim=-1)),
        "rho": rho,
        "wire_bits_per_edge": bits,
        "wire_bytes_total": total,
        "ef_residual_norm": resid,
    }


def apply_attack_bank(attacks, attack_idx, w: torch.Tensor, byz_mask: torch.Tensor, keys,
                      t: int) -> torch.Tensor:
    """The broadcast attack of each cell of ``w [E, M, d]``: ``attacks``
    a static bank, ``attack_idx [E]`` each cell's entry, ``byz_mask [E, M]``
    and ``keys`` the cells' host row keys ``[E, 2]``.  Each attack runs
    once, over the cells that chose it, and the rows are scattered back."""
    idx = np.asarray(attack_idx, np.int64)
    used = sorted(set(idx.tolist()))
    if len(used) == 1:
        return attacks[used[0]](w, byz_mask, draw_key(keys), t)
    out = torch.empty_like(w)
    for a in used:
        cells = np.nonzero(idx == a)[0]
        sel = torch.as_tensor(cells, device=w.device)
        out.index_copy_(0, sel, attacks[a](w.index_select(0, sel), byz_mask.index_select(0, sel),
                                           draw_key(keys[cells]), t))
    return out


def draw_key(keys: np.ndarray):
    """The key a draw over E cells takes: one cell's host key (``[2]``, the
    trainer's draw, with no copy to the card) or the cells' host row keys
    ``[E, 2]`` (row e drawn under key e, bit for bit the one-cell draw)."""
    return keys[0] if keys.shape[0] == 1 else keys


def _index(idx, units: int):
    """A bank index a cell as the banks take it: None (entry 0 for all)
    when empty, else repeated ``units`` times a cell (its links)."""
    if not idx:
        return None
    return np.repeat(np.asarray(idx, np.int64), units) if units > 1 else idx


def wire_stage(codecs, wire_attacks, cell: CellParams, sub: np.ndarray, x: torch.Tensor,
               comm, byz: torch.Tensor, t: int, edge_ids: torch.Tensor | None = None):
    """Encode -> codeword attack -> decode with the carry, for E cells:
    the reference's ``_wire_roundtrip``.  ``codecs`` and ``wire_attacks``
    are static banks (each cell's entries chosen by ``cell.codec_idx`` and
    ``cell.attack_idx``), ``sub`` the cells' host subkeys ``[E, 2]``.

    Synchronous (``edge_ids`` None): ``x [E, M, d]`` per sender, cell e
    encoded under ``fold_in(sub_e, COMM_SALT)`` and attacked under
    ``fold_in(sub_e, WIRE_SALT)``, ``byz [E, M]``.  Per link: ``x [E, M,
    W, d]``, every link under its edge's keys ``fold_in(.., edge_id)``
    (``edge_ids [M, W]``), ``byz [E, M, W]`` the senders' mask, so the dense
    and the sparse layouts draw the same codewords on matching edges.
    Returns ``(x_hat, comm')``.  Banks that cannot alter a payload (every
    codec lossless, no wire attack) skip the stage."""
    if exchange.bank_is_lossless(codecs) and all(a.name == "none" for a in wire_attacks):
        return x, comm
    d = x.shape[-1]
    zero_folded = not any(a.rewrites_scale for a in wire_attacks)
    comm_key, wire_key = prng.fold_in(sub, COMM_SALT), prng.fold_in(sub, WIRE_SALT)
    if edge_ids is None:
        c_idx = _index(cell.codec_idx, 1) if len(codecs) > 1 else None
        a_idx = cell.attack_idx if len(wire_attacks) > 1 else None
        ck, wk = draw_key(comm_key), draw_key(wire_key)
        msg, target = exchange.encode_bank(codecs, c_idx, ck, x, comm)
        msg = byzantine.apply_wire_attack_bank(wire_attacks, a_idx, msg, byz, wk, t, d)
        return exchange.decode_bank(codecs, c_idx, msg, target, comm, ck, zero_folded)
    lead = x.shape[:-1]
    links = int(np.prod(lead[1:]))
    ids = edge_ids.reshape(-1)
    ck, wk = prng.fold_in(comm_key, ids), prng.fold_in(wire_key, ids)
    c_idx = _index(cell.codec_idx, links) if len(codecs) > 1 else None
    a_idx = _index(cell.attack_idx, links) if len(wire_attacks) > 1 else None
    rows = lambda a: a.reshape(-1, d)
    carry = None if comm is None else exchange.CommState(*(rows(a) for a in comm))
    msg, target = exchange.encode_bank(codecs, c_idx, ck, rows(x), carry)
    msg = byzantine.apply_wire_attack_bank(wire_attacks, a_idx, msg, byz.reshape(-1), wk, t, d)
    x_hat, carry = exchange.decode_bank(codecs, c_idx, msg, target, carry, ck, zero_folded)
    unrows = lambda a: a.reshape(*lead, d)
    return unrows(x_hat), (None if carry is None
                           else exchange.CommState(*(unrows(a) for a in carry)))


def _adversary_bank(adversaries):
    """The static adversary bank, or None when it cannot alter a broadcast
    (the stage is then skipped)."""
    bank = None if adversaries is None else adv_lib.adversary_bank(adversaries)
    return bank if adv_lib.bank_engaged(bank) else None


def _theta(bank, cell: CellParams) -> np.ndarray:
    return adv_lib.cell_theta(bank, cell.adv_idx or (0,) * cell.num_cells, cell.adv_theta)


def obs_stage(spec, state: BridgeState, metrics: dict, *, trim=None, live=None, byz_edge=None,
              staleness=None, wire_bits=None, live_edges=None, d: int | None = None):
    """The ``bridge.obs`` stage: the tick folded into ``state.obs``
    (unchanged when ``spec`` is None); with the tick's trim fractions
    ``trim`` (forensics), also the ``obs_trim_frac`` metric."""
    if spec is None:
        return state.obs
    with torch.profiler.record_function("bridge.obs"):
        if trim is not None:
            metrics["obs_trim_frac"] = obs_trace.obs_trim_frac(trim, live)
        return obs_trace.update(spec, state.obs, t=state.t, loss=metrics["loss"],
                                consensus=metrics["consensus_dist"], trim_frac=trim, live=live,
                                byz_edge=byz_edge, staleness=staleness, wire_bits=wire_bits,
                                live_edges=live_edges, d=d)


def decide_stride(trace, trust) -> int:
    """The decide form's column stride: the trace's when it has forensics,
    else the trust spec's (the reference's precedence)."""
    return trace.decide_stride if trace is not None and trace.forensics else trust.decide_stride


def trust_stage(spec, state: BridgeState, metrics: dict, *, trim, screened, live,
                echo_evidence=None):
    """The ``bridge.trust`` stage: the tick's trim fractions on the
    ``screened`` edges (and the echo's evidence) folded into
    ``state.trust`` over the ``live`` edges, and the
    ``trust_evicted_frac`` metric (unchanged when ``spec`` is None)."""
    if spec is None:
        return state.trust
    with torch.profiler.record_function("bridge.trust"):
        new = trust_lib.update(spec, state.trust, t=state.t,
                               trim_frac=torch.where(screened, trim, 0.0), live=live,
                               echo_evidence=echo_evidence)
        metrics["trust_evicted_frac"] = torch.mean(new.evicted.to(torch.float32), dim=(-2, -1))
    return new


def apply_update(y: torch.Tensor, rho, g: torch.Tensor) -> torch.Tensor:
    """(Step 6) ``y - rho * g``, the product through `screening.fence`
    first: rounded once to float32 before the subtract, never contracted
    with it into one fused multiply-add (the reference's fence,
    `repro.core.bridge`'s apply).  ``rho`` a float or ``[E, 1, 1]``."""
    return y - screening.fence(rho * g, "bridge.apply")


def grad_norm(g: torch.Tensor, honest: torch.Tensor) -> torch.Tensor:
    """The ``grad_norm`` metric: the honest nodes' mean per-node gradient
    l2 norm, one a cell (``g [E, M, d]``, ``honest [E, M]``), over the
    fenced gradient (the reference's)."""
    g = screening.fence(g, "bridge.grad_norm")
    gn = torch.sqrt(torch.sum(g * g, dim=-1))
    return (torch.sum(torch.where(honest, gn, 0.0), dim=-1)
            / torch.sum(honest, dim=-1).to(torch.float32))


def fold_metric_ring(spec, state: BridgeState, metrics: dict, *, staleness=None, live=None):
    """The ``bridge.metrics`` stage: the tick's scalars, already computed,
    folded into ``state.mets`` (unchanged when ``spec`` is None).  The
    trace's ``obs_trim_frac`` is the ring's ``trim_frac``, trust's
    ``trust_evicted_frac`` its ``evicted_frac``; with the delivered
    messages' ages ``staleness`` and their ``live`` mask (the runtime), the
    ``stale_p50`` / ``stale_p90`` columns."""
    if spec is None:
        return state.mets
    with torch.profiler.record_function("bridge.metrics"):
        vals = {k: metrics[k] for k in ("loss", "consensus_dist", "grad_norm", "rho",
                                        "wire_bits_per_edge", "wire_bytes_total")
                if k in metrics}
        if "obs_trim_frac" in metrics:
            vals["trim_frac"] = metrics["obs_trim_frac"]
        if "trust_evicted_frac" in metrics:
            vals["evicted_frac"] = metrics["trust_evicted_frac"]
        if staleness is not None and live is not None:
            vals.update(obs_metrics.stale_quantiles(staleness, live))
        return obs_metrics.update(spec, state.mets, t=state.t, vals=vals)


def build_cell_step(grad_fn: Callable, adjacency: torch.Tensor, rules: tuple[str, ...],
                    attacks, *, neighbors: NeighborTable | None = None,
                    codecs: tuple[str, ...] = ("identity",), wire_attacks=None,
                    adversaries: tuple[str, ...] | None = None, trace=None, trust=None,
                    screen_chunk: int | None = None):
    """The synchronous-broadcast iteration over stacked cells:
    ``step(cell, state, batch) -> (state, metrics)``, the reference's
    ``build_cell_step`` with a rule bank ``rules``, an attack bank
    ``attacks`` (`byzantine.Attack`s), a codec bank ``codecs`` (names), the
    wire attacks ``wire_attacks`` parallel to ``attacks`` (default: none),
    an adversary bank ``adversaries`` (names; None or all ``none`` skips
    the stage), a `repro_torch.obs.TraceSpec` ``trace`` (None: no obs
    stage) and a `repro_torch.trust.TrustSpec` ``trust`` (None: no trust
    stage), and ``cell`` a `CellParams` of E cells.

    ``state`` holds ``params`` ``[E, M, ...]``, the tick ``t`` all cells
    share, ``key`` the cells' host row keys ``[E, 2]``, the codec carry
    ``comm`` ``[E, M, d]`` (a lossy bank) and the adversary's ``adv``
    ``[E, d]`` (a stateful bank), the trace's ``obs`` (a ``trace``) and the
    trust layer's ``trust`` (a ``trust``);
    ``grad_fn`` takes the ``[E, M, ...]``
    parameters and the tick's one batch and returns ``(losses [E, M],
    grads)``.  Screening is `screening.screen_all_banked` under the
    ``[M, M]`` ``adjacency`` or, with ``neighbors``,
    `screening.screen_gathered_banked`: each kernel launches once for the
    cells that chose its rule.  The adversary's screening oracle is the
    same screen, each node's own value the crafted broadcast.  The metrics
    are ``[E]`` tensors (``rho`` a float32 ``[E]`` array).

    The screen takes the reference's branch order: trust on always runs
    the decide form, with the reputation weights and the evictions cleared
    from each cell's mask (``[E, M, W]``); forensics alone decides under
    the static mask; otherwise the plain screen, whose plain rules stream
    past ``screen_chunk`` coordinates.  With ``cell.metrics`` the tick's
    scalars fold into ``state.mets`` (`fold_metric_ring`).
    """
    codec_bank = codec_lib.codec_bank(codecs)
    if wire_attacks is None:
        wire_attacks = (byzantine.WIRE_ATTACKS["none"],) * len(attacks)
    adv_bank = _adversary_bank(adversaries)
    n_edges = float(torch.sum(adjacency.to(torch.float32)))
    static_live = neighbors.valid_dev.bool() if neighbors is not None else adjacency.bool()
    forensics = trace is not None and trace.forensics

    def screen(w_hat, w_bcast, cell):
        if neighbors is not None:
            return screening.screen_gathered_banked(w_hat, neighbors, rules, cell.rule_idx,
                                                    cell.b, self_vals=w_bcast, chunk=screen_chunk)
        return screening.screen_all_banked(w_hat, adjacency, rules, cell.rule_idx, cell.b,
                                           self_vals=w_bcast, chunk=screen_chunk)

    def screen_decide(w_hat, w_bcast, cell, stride, weights=None, evicted=None):
        """The decide form: ``(y, trim)``; ``evicted`` clears a cell's
        evicted edges from its mask (whose divisors the averaging rules
        then divide, as the reference's run-time mask does)."""
        mask = None if evicted is None else static_live & ~evicted
        if neighbors is not None:
            return screening.screen_gathered_decide_banked(
                w_hat, neighbors, rules, cell.rule_idx, cell.b, self_vals=w_bcast, valid=mask,
                decide_stride=stride, weights=weights, folded=evicted is None)
        return screening.screen_all_decide_banked(
            w_hat, adjacency if mask is None else mask, rules, cell.rule_idx, cell.b,
            self_vals=w_bcast, decide_stride=stride, weights=weights, folded=evicted is None)

    def step(cell: CellParams, state: BridgeState, batch) -> tuple[BridgeState, dict]:
        w, unflatten = stack_flatten(state.params, lead=2)
        d = w.shape[-1]
        keys = prng.split(state.key)  # [E, 2, 2] on the host
        key, sub = keys[:, 0], keys[:, 1]
        # (Steps 3-4) broadcast with Byzantine substitution
        with torch.profiler.record_function("bridge.attack"):
            w_bcast = apply_attack_bank(attacks, cell.attack_idx, w, cell.byz_mask, sub, state.t)
        adv = state.adv
        if adv_bank is not None:
            # the adversary observes the honest rows and re-crafts the
            # Byzantine ones; its oracle is the cells' own screen
            with torch.profiler.record_function("bridge.adversary"):
                ctx = adv_lib.AdvCtx(screen=lambda wb, cells: screen(
                    wb, wb, cell if cells is None else cell.select(cells)))
                w_bcast, adv = adv_lib.apply_adversary_bank(
                    adv_bank, cell.adv_idx or None, ctx, state.adv, _theta(adv_bank, cell),
                    w_bcast, cell.byz_mask, draw_key(prng.fold_in(sub, ADV_SALT)), state.t)
        # wire codec: what receivers decode (identity: w_bcast itself)
        with torch.profiler.record_function("bridge.codec"):
            w_hat, comm = wire_stage(codec_bank, wire_attacks, cell, sub, w_bcast, state.comm,
                                     cell.byz_mask, state.t)
        # (Step 5) screening at every node; self is the node's own broadcast,
        # which never travels the wire
        trim = None
        if trust is not None or forensics:
            screening.check_decide_streams(rules, d, screen_chunk)
        with torch.profiler.record_function("bridge.screen"):
            if trust is not None:
                y, trim = screen_decide(w_hat, w_bcast, cell, decide_stride(trace, trust),
                                        weights=trust_lib.edge_weights(trust, state.trust),
                                        evicted=state.trust.evicted)
            elif forensics:
                y, trim = screen_decide(w_hat, w_bcast, cell, trace.decide_stride)
            else:
                y = screen(w_hat, w_bcast, cell)
        # (Step 6) local gradient step at w_j(t)
        with torch.profiler.record_function("bridge.apply"):
            losses, grads = grad_fn(state.params, batch)
            g, _ = stack_flatten(grads, lead=2)
            rho = cell_step_size(cell.lam, cell.t0, cell.lr, state.t)
            w_new = apply_update(y, _per_cell(rho, w.device), g)
            metrics = cell_metrics(w_new, losses, ~cell.byz_mask, rho,
                                   exchange.wire_bits_bank(codec_bank, cell.codec_idx or None, d),
                                   n_edges, comm)
            if cell.metrics is not None:
                metrics["grad_norm"] = grad_norm(g, ~cell.byz_mask)
        live = byz_edge = None
        if trim is not None:
            e, m = w.shape[:2]
            live = static_live.expand(e, *static_live.shape)
            byz_edge = (neighbors.gather_senders(cell.byz_mask, fill=False) if neighbors is not None
                        else cell.byz_mask[:, None, :].expand(e, m, m))
        obs = obs_stage(trace, state, metrics, trim=trim, live=live,
                        byz_edge=byz_edge,
                        wire_bits=exchange.wire_bits_bank(codec_bank, cell.codec_idx or None, d),
                        live_edges=n_edges, d=d)
        # no echo on the broadcast path: one payload a sender, so trim
        # evidence only
        new_trust = None
        if trust is not None:
            live_t = static_live & ~state.trust.evicted
            new_trust = trust_stage(trust, state, metrics, trim=trim, screened=live_t,
                                    live=live_t)
        mets = fold_metric_ring(cell.metrics, state, metrics)
        return BridgeState(unflatten(w_new), state.t + 1, key, comm, adv=adv, obs=obs,
                           trust=new_trust, mets=mets), metrics

    return step


def _per_cell(rho: np.ndarray, device) -> float | torch.Tensor:
    """The step sizes as the update takes them: a float when every cell
    shares it (a grid's cells share t and, as in the reference's grids, the
    schedule), else ``[E, 1, 1]`` float32 on ``device``."""
    if np.all(rho == rho[0]):
        return float(rho[0])
    return torch.as_tensor(rho, device=device)[:, None, None]


def _need(counts: np.ndarray, device) -> int | torch.Tensor:
    """The Table-II minimums ``[E]`` against usable counts ``[E, M]``: an
    int when every cell shares it, else an ``[E, 1]`` tensor (made once per
    distinct tuple, `screening.bound_arg`)."""
    arg = screening.bound_arg(tuple(int(c) for c in counts), device)
    return arg if isinstance(arg, int) else arg[:, None]


def build_cell_runtime_step(grad_fn: Callable, runtime, rules: tuple[str, ...],
                            message_attacks, *, codecs: tuple[str, ...] = ("identity",),
                            wire_attacks=None, adversaries: tuple[str, ...] | None = None,
                            trace=None, trust=None, screen_chunk: int | None = None):
    """The network-runtime iteration over stacked cells: ``step(cell,
    state, batch) -> (state, metrics)``, the reference's
    ``build_cell_runtime_step`` with a rule bank ``rules``, a bank of
    `byzantine.MessageAttack`s and the codec, wire-attack and adversary
    banks, the ``trace`` and the ``trust`` of `build_cell_step`.

    ``state`` holds ``params`` ``[E, M, ...]``, the tick ``t`` all cells
    share, ``key`` the cells' host row keys ``[E, 2]``, ``net`` the
    runtime's state with a leading ``[E]`` axis, the per-link codec carry
    ``comm`` ``[E, M, W, d]`` and the adversary's ``adv``.  The stages and
    keys are the reference's: ``key, sub = split(key)``; per-link messages
    and the self-views (`byzantine.messages_and_self_bank`, under ``sub``);
    the adversary's message form, whose lies replace the Byzantine senders'
    links only (honest links keep their messages bitwise); the codec per
    link (`wire_stage`), a link's carry advancing on the tick's live edges
    only; the exchange under ``fold_in(sub, NET_SALT)``; every node screens
    its views (`screening.screen_views_banked`: the views kernels with the
    experiment axis on the card, one launch a rule for all the cells), and
    a node short of its rule's Table-II minimum keeps its own value; then
    the local gradient step.  The metrics are ``[E]``, the runtime's stats
    included.

    A runtime with ``cell_aware = True`` (`repro_torch.sim.engine.GridNetRuntime`)
    gets the cells, so it can pick each cell's scenario: ``adjacency_at(t,
    cell)`` and ``exchange(..., cell)``; the others keep their contract,
    one live mask for every cell.  The adversary's oracle screens the live
    edges; on a runtime with one channel it also sees the coordinates a
    capped channel delivers this tick and the channel's mean latency (a
    cell-aware runtime: every coordinate, latency 0, as in the reference).

    With ``trust`` the screen decides over the usable mask less each
    cell's evictions, and, with ``trust.echo``, the ``bridge.echo`` stage
    cross-checks the nodes' digests of their views for equivocation
    (`repro_torch.trust.echo`; ``slander``'s nodes forge the digest rows
    they gossip) before the ``bridge.trust`` stage folds the evidence in.
    With ``cell.metrics`` the tick's scalars, the delivered messages' age
    quantiles included, fold into ``state.mets``; ``screen_chunk`` as in
    `build_cell_step`.
    """
    forensics = trace is not None and trace.forensics
    codec_bank = codec_lib.codec_bank(codecs)
    if wire_attacks is None:
        wire_attacks = (byzantine.WIRE_ATTACKS["none"],) * len(message_attacks)
    adv_bank = _adversary_bank(adversaries)
    accuses = adv_lib.bank_accuses(adv_bank)
    from repro_torch.net.mailbox import NEVER  # the net package imports this module
    cell_aware = bool(getattr(runtime, "cell_aware", False))
    nbr = getattr(runtime, "neighbors", None)
    channel = getattr(runtime, "channel", None)
    adv_latency = 0.0 if channel is None else 0.5 * (channel.latency_min + channel.latency_max)

    def oracle(wb, adj_t, cell, cells):
        """The adversary's screen over the cells ``cells`` of the call."""
        c = cell if cells is None else cell.select(cells)
        if adj_t.ndim == 3 and cells is not None:
            adj_t = adj_t.index_select(0, torch.as_tensor(cells, device=adj_t.device))
        if nbr is not None:
            return screening.screen_views_banked(nbr.gather_rows(wb, lead=1), adj_t, wb, rules,
                                                 c.rule_idx, c.b, chunk=screen_chunk)
        return screening.screen_all_banked(wb, adj_t, rules, c.rule_idx, c.b, self_vals=wb,
                                           chunk=screen_chunk)

    def adversary(cell, state, w, msgs, w_self, adj_t, sub):
        """The adversary's message form over the Byzantine senders' links."""
        e, m, d = w.shape
        deliver = None
        peek = getattr(runtime, "delivered_coord_mask", None)
        if peek is not None and not cell_aware:
            deliver = peek(prng.fold_in(sub[0], NET_SALT), d)
        ctx = adv_lib.AdvCtx(screen=lambda wb, cells: oracle(wb, adj_t, cell, cells),
                             deliver_mask=deliver, latency=adv_latency)
        args = (adv_bank, cell.adv_idx or None, ctx, state.adv, _theta(adv_bank, cell), w,
                cell.byz_mask)
        key = draw_key(prng.fold_in(sub, ADV_SALT))
        if nbr is not None:
            adv_msgs, adv_self, adv = adv_lib.apply_sparse_message_adversary_bank(
                *args, nbr, adj_t, key, state.t)
            senders = nbr.gather_senders(cell.byz_mask, fill=False)
        else:
            adv_msgs, adv_self, adv = adv_lib.apply_message_adversary_bank(
                *args, adj_t, key, state.t)
            senders = cell.byz_mask[:, None, :].expand(e, m, m)
        msgs = torch.where(senders[..., None], adv_msgs, msgs)
        w_self = torch.where(cell.byz_mask[..., None], adv_self, w_self)
        return msgs, w_self, adv

    def link_codec(cell, sub, msgs, comm, adj_t, t):
        """The codec per link; a link's carry advances only for messages put
        on the wire this tick (live edges; channel drops are downstream)."""
        e, m = msgs.shape[:2]
        if nbr is not None:
            byz_link, ids = nbr.gather_senders(cell.byz_mask, fill=False), nbr.edge_ids
        else:
            byz_link = cell.byz_mask[:, None, :].expand(e, m, m)
            ids = torch.as_tensor(edge_id_grid(m), device=msgs.device)
        x_hat, new = wire_stage(codec_bank, wire_attacks, cell, sub, msgs, comm, byz_link, t,
                                edge_ids=ids)
        if comm is not None and new is not comm:
            new = exchange.CommState(*(torch.where(adj_t[..., None], a, b)
                                       for a, b in zip(new, comm, strict=True)))
        return x_hat, new

    def byz_links(cell, e, m):
        """``[E, M, W]``: whether each link's sender is Byzantine."""
        if nbr is not None:
            return nbr.gather_senders(cell.byz_mask, fill=False)
        return cell.byz_mask[:, None, :].expand(e, m, m)

    def echo(cell, state, net, views, mask, mask_eff, adj_t, sub):
        """The ``bridge.echo`` stage: ``[E, M, W]`` 0 / 1 evidence of
        quorum-confirmed equivocation on each usable edge."""
        with torch.profiler.record_function("bridge.echo"):
            trust_key = prng.fold_in(sub, TRUST_SALT)  # [E, 2] on the host
            gens = getattr(net, "send_tick", None)
            if gens is None:  # a net-less runtime: every usable view was sent this tick
                gens = torch.where(mask, state.t, NEVER).to(torch.int32)
            e, m = views.shape[:2]
            adj = adj_t.expand(e, *adj_t.shape[-2:])
            dig = echo_lib.digest_all(trust, views, trust_key)
            if nbr is not None:
                dig = echo_lib.scatter_dense(nbr, dig, 0.0, tail=1)
                gens = echo_lib.scatter_dense(nbr, gens.expand(e, *gens.shape[-2:]), NEVER)
                valid = echo_lib.scatter_dense(nbr, mask_eff, False)
                gossip = echo_lib.scatter_dense(nbr, adj, False)
            else:
                valid, gossip = mask_eff, adj
            if accuses:
                # slanderers forge the digest rows they report; their own
                # receptions stay honest
                dig = adv_lib.apply_accuse_bank(adv_bank, cell.adv_idx or None,
                                                _theta(adv_bank, cell), dig, cell.byz_mask,
                                                draw_key(trust_key), state.t)
            ev, _ = echo_lib.equivocation_evidence(dig, gens, valid, gossip, cell.b,
                                                   tol=trust.echo_tol)
            return nbr.gather_edges(ev, 0.0) if nbr is not None else ev

    def step(cell: CellParams, state: BridgeState, batch) -> tuple[BridgeState, dict]:
        w, unflatten = stack_flatten(state.params, lead=2)
        e, m, d = w.shape
        keys = prng.split(state.key)  # [E, 2, 2] on the host
        key, sub = keys[:, 0], keys[:, 1]
        # the tick's live mask: [M, W] (or [E, M, W], one a cell); W = M
        # dense, the table's K sparse
        adj_t = runtime.adjacency_at(state.t, cell) if cell_aware else runtime.adjacency_at(state.t)
        # (Steps 3-4) per-link messages with Byzantine substitution; nodes
        # screen with the value they broadcast (a message-only attack: the
        # true iterate)
        with torch.profiler.record_function("bridge.attack"):
            msgs, w_self = byzantine.messages_and_self_bank(
                message_attacks, cell.attack_idx, w, cell.byz_mask, adj_t, sub, state.t, nbr)
        adv = state.adv
        if adv_bank is not None:
            with torch.profiler.record_function("bridge.adversary"):
                msgs, w_self, adv = adversary(cell, state, w, msgs, w_self, adj_t, sub)
        with torch.profiler.record_function("bridge.codec"):
            msgs, comm = link_codec(cell, sub, msgs, state.comm, adj_t, state.t)
        bits = exchange.wire_bits_bank(codec_bank, cell.codec_idx or None, d)
        with torch.profiler.record_function("bridge.exchange"):
            args = (state.net, msgs, w_self, adj_t, draw_key(prng.fold_in(sub, NET_SALT)),
                    state.t)
            net, views, mask, net_stats = (runtime.exchange(*args, cell, wire_bits=bits)
                                           if cell_aware else
                                           runtime.exchange(*args, wire_bits=bits))
        # (Step 5) screening over the usable views; a node short of its
        # rule's Table-II minimum keeps its own value this tick
        trim = None
        mask_eff = mask
        if trust is not None or forensics:
            screening.check_decide_streams(rules, d, screen_chunk)
        with torch.profiler.record_function("bridge.screen"):
            if trust is not None:
                # evicted edges leave the usable mask, as if the link had died
                mask_eff = mask & ~state.trust.evicted
                y_rule, trim = screening.screen_views_decide_banked(
                    views, mask_eff, w_self, rules, cell.rule_idx, cell.b,
                    decide_stride=decide_stride(trace, trust),
                    weights=trust_lib.edge_weights(trust, state.trust))
            elif forensics:
                y_rule, trim = screening.screen_views_decide_banked(
                    views, mask, w_self, rules, cell.rule_idx, cell.b,
                    decide_stride=trace.decide_stride)
            else:
                y_rule = screening.screen_views_banked(views, mask, w_self, rules, cell.rule_idx,
                                                       cell.b, chunk=screen_chunk)
            need = screening.min_neighbors_banked(rules, cell.rule_idx, cell.b)
            enough = mask_eff.sum(dim=-1) >= _need(need, w.device)
            y = torch.where(enough[..., None], y_rule, w_self)
        # (Step 6) local gradient step at w_j(t)
        with torch.profiler.record_function("bridge.apply"):
            losses, grads = grad_fn(state.params, batch)
            g, _ = stack_flatten(grads, lead=2)
            rho = cell_step_size(cell.lam, cell.t0, cell.lr, state.t)
            w_new = apply_update(y, _per_cell(rho, w.device), g)
            live = torch.sum(adj_t, dim=(-2, -1)).to(torch.float32).expand(e)
            metrics = cell_metrics(w_new, losses, ~cell.byz_mask, rho, bits, live, comm)
            if cell.metrics is not None:
                metrics["grad_norm"] = grad_norm(g, ~cell.byz_mask)
        metrics.update(net_stats)
        metrics["screened_frac"] = torch.mean(enough.to(torch.float32), dim=-1)
        live_o = byz_edge = None
        if trim is not None:
            # nodes starved below the Table-II minimum kept their own value:
            # their rows were not screened this tick
            live_o = mask_eff & enough[..., None]
            trim = torch.where(live_o, trim, 0.0)
            byz_edge = byz_links(cell, e, m) & live_o
        obs = obs_stage(trace, state, metrics, trim=trim, live=live_o, byz_edge=byz_edge,
                        staleness=obs_trace.staleness_of(net, state.t), wire_bits=bits,
                        live_edges=live, d=d)
        new_trust = None
        if trust is not None:
            echo_ev = (echo(cell, state, net, views, mask, mask_eff, adj_t, sub) if trust.echo
                       else None)
            new_trust = trust_stage(trust, state, metrics, trim=trim,
                                    screened=mask_eff & enough[..., None], live=mask_eff,
                                    echo_evidence=echo_ev)
        mets = fold_metric_ring(cell.metrics, state, metrics,
                                staleness=obs_trace.staleness_of(net, state.t), live=mask)
        return BridgeState(unflatten(w_new), state.t + 1, key, comm, net, adv, obs,
                           new_trust, mets), metrics

    return step


def _cells(net, fn):
    """``fn`` over every tensor of a carried state (a tensor, a NamedTuple
    or a tuple of them, nested: the stream's per-leaf carries; or None):
    adds or drops the cells' axis."""
    if net is None or isinstance(net, torch.Tensor):
        return None if net is None else fn(net)
    parts = (_cells(x, fn) for x in net)
    return type(net)(*parts) if hasattr(net, "_fields") else tuple(parts)


def _one_cell(grad_fn: Callable) -> Callable:
    """A trainer's ``grad_fn`` (over ``[M, ...]``) as the cell step calls it,
    over one cell's ``[1, M, ...]``."""

    def fn(params: Params, batch):
        losses, grads = grad_fn({k: v[0] for k, v in params.items()}, batch)
        return losses[None], {k: v[None] for k, v in grads.items()}

    return fn


def stack_streams(history: list[dict], device) -> dict:
    """Per-tick metric dicts as ``[T]`` float32 tensors on ``device``: the
    device values stacked, the host values (floats) copied over once a
    key."""
    out = {}
    for k in history[0] if history else ():
        vals = [h[k] for h in history]
        if isinstance(vals[0], torch.Tensor):
            out[k] = torch.stack([v.to(torch.float32) for v in vals])
        else:
            out[k] = torch.as_tensor(np.asarray(vals, np.float32), device=device)
    return out


class CellTrainer:
    """The loops of a trainer of one cell: `step`, `run` and `run_chunks`
    over ``self._cell_step`` (a cell step, `build_cell_step`'s signature)
    and ``self.cell`` (its `CellParams`, E = 1), with ``self.config`` and
    ``self.device``, which a subclass sets."""

    def step(self, state: BridgeState, batch: Any) -> tuple[BridgeState, dict]:
        """One tick of the trainer's cell step over its one cell (E = 1).  The metrics are 0-d tensors on the
        device (reading one waits for the tick) and Python floats for the
        static quantities."""
        add = lambda x: x[None]
        one = BridgeState({k: v[None] for k, v in state.params.items()}, state.t,
                          np.asarray(state.key, np.uint32)[None], _cells(state.comm, add),
                          _cells(state.net, add), _cells(state.adv, add), _cells(state.obs, add),
                          _cells(state.trust, add), _cells(state.mets, add))
        new, metrics = self._cell_step(self.cell, one, batch)
        metrics = {k: (v[0] if isinstance(v, torch.Tensor) and v.ndim else
                       float(v[0]) if isinstance(v, np.ndarray) else v)
                   for k, v in metrics.items()}
        drop = lambda x: x[0]
        return BridgeState({k: v[0] for k, v in new.params.items()}, new.t, new.key[0],
                           _cells(new.comm, drop), _cells(new.net, drop),
                           _cells(new.adv, drop), _cells(new.obs, drop),
                           _cells(new.trust, drop), _cells(new.mets, drop)), metrics

    def run(self, state: BridgeState, batch_fn: Callable[[int], Any], num_steps: int,
            eval_fn: Callable | None = None, eval_every: int = 0) -> tuple[BridgeState, list[dict]]:
        """``num_steps`` ticks; every ``eval_every`` ticks the metrics (as
        Python numbers) and ``eval_fn(state)`` join the returned history."""
        history = []
        for i in range(num_steps):
            state, metrics = self.step(state, batch_fn(i))
            if eval_fn is not None and eval_every and (i + 1) % eval_every == 0:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(eval_fn(state))
                rec["step"] = i + 1
                history.append(rec)
        return state, history

    def run_chunks(self, state: BridgeState, batch_fn: Callable[[int], Any], num_steps: int, *,
                   chunk: int | None = None, writer=None, events=None, tag: str = "train",
                   start: int = 0) -> tuple[BridgeState, dict]:
        """``num_steps`` ticks (batches ``batch_fn(start)``,
        ``batch_fn(start + 1)``, ...) as a host loop over chunks of
        ``chunk`` ticks, the reference's ``run_chunks``: within a chunk the
        ticks are launched back to back, never waited for; after each chunk
        the metric ring goes to ``writer`` (a `repro_torch.obs.MetricWriter`,
        whose copy does not wait for the card) and a ``train.chunk`` record
        (``train_tag``, ``lo``, ``hi``, ``dispatch_s``: the host's time to
        launch the chunk) to ``events``.  ``chunk`` defaults to the metric
        spec's capacity (no tick overwritten before it is flushed), or 64
        without one.  Returns ``(final_state, metrics)`` with ``[T]``
        tensor streams, each tick's values those of `step` in a loop."""
        mspec = self.config.metrics
        if chunk is None:
            chunk = mspec.capacity if mspec is not None else 64
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if mspec is not None and chunk > mspec.capacity:
            raise ValueError(f"chunk {chunk} exceeds MetricSpec.capacity {mspec.capacity}: the "
                             f"ring would overwrite unflushed ticks")
        history: list[dict] = []
        done = start
        while done < start + num_steps:
            hi = min(done + chunk, start + num_steps)
            t_chunk = time.perf_counter()
            for i in range(done, hi):
                state, metrics = self.step(state, batch_fn(i))
                history.append(metrics)
            if writer is not None:
                writer.flush(state.mets, tag=tag)
            if events is not None:
                # `train_tag`, not `tag`: the event's first field is its tag
                events.emit("train.chunk", train_tag=tag, lo=done, hi=hi,
                            dispatch_s=time.perf_counter() - t_chunk)
            done = hi
        return state, stack_streams(history, self.device)


class BridgeTrainer(CellTrainer):
    """Drives Algorithm 1.  ``grad_fn(params, batch) -> (losses [M], grads)``
    computes every node's local loss and gradient over the stacked
    ``[M, ...]`` parameters (e.g. `repro_torch.models.small.linear_loss_and_grad`).

    ``runtime`` plugs in a message-exchange model (`repro_torch.net.runtime`,
    on the trainer's device): None is the synchronous broadcast; a runtime
    gives asynchronous BRIDGE over its network (see the module docstring).
    With an ideal channel and a static schedule the runtime path equals the
    synchronous one bit for bit.
    """

    def __init__(self, config: BridgeConfig, grad_fn: Callable, *, runtime=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        config.topology.validate_for_rule(config.rule)
        self.config = config
        self.grad_fn = grad_fn
        self.runtime = runtime
        self.wire_attack = byzantine.wire_attack_for(config.attack)
        adj = config.topology.adjacency
        self.adjacency = torch.as_tensor(adj, dtype=torch.bool, device=self.device)
        self.codec = codec_lib.get_codec(config.codec)
        # the adversary stage is engaged only when one is named
        self.adversary = (None if config.adversary == "none"
                          else adv_lib.get_adversary(config.adversary))
        advs = None if self.adversary is None else (config.adversary,)
        banks = dict(codecs=(config.codec,), wire_attacks=(self.wire_attack,), adversaries=advs,
                     trace=config.trace, trust=config.trust, screen_chunk=config.screen_chunk)
        self.neighbors = None
        if runtime is None:
            self.attack = byzantine.get_attack(config.attack)
            if config.sparse:
                self.neighbors = NeighborTable.from_adjacency(adj, device=self.device)
            self._cell_step = build_cell_step(
                _one_cell(grad_fn), self.adjacency, (config.rule,), (self.attack,),
                neighbors=self.neighbors, **banks)
        else:
            self._check_runtime(runtime)
            self.message_attack = byzantine.get_message_attack(config.attack)
            self._cell_step = build_cell_runtime_step(
                _one_cell(grad_fn), runtime, (config.rule,), (self.message_attack,), **banks)
        # an adversary alone also draws the Byzantine nodes (the reference's rule)
        engaged = config.attack if self.adversary is None else config.adversary
        self.byz_mask = byzantine.byzantine_nodes(config.topology.num_nodes, config.num_byzantine,
                                                  engaged, config.byzantine_seed, self.device)
        theta = None
        if self.adversary is not None:
            theta = np.asarray([self.adversary.default_theta], np.float32)
        self.cell = CellParams((0,), (0,), (config.num_byzantine,), self.byz_mask[None],
                               (config.lam,), (config.t0,), (config.lr,), codec_idx=(0,),
                               adv_idx=() if self.adversary is None else (0,), adv_theta=theta,
                               metrics=config.metrics)

    def _check_runtime(self, runtime) -> None:
        """The reference's refusals, and the port's: a runtime on another
        device."""
        cfg = self.config
        if cfg.sparse and getattr(runtime, "neighbors", None) is None:
            raise ValueError(
                "BridgeConfig(sparse=True) with an explicit dense runtime: pass a "
                "neighbor-indexed runtime (SparseUnreliableRuntime) or drop the flag "
                "— a dense runtime would silently keep the O(M^2) state layout")
        rt_dev = getattr(runtime, "device", self.device)
        if torch.device(rt_dev) != self.device:
            raise ValueError(f"runtime on {rt_dev}, trainer on {self.device}")

    @property
    def honest_mask(self) -> torch.Tensor:
        return ~self.byz_mask

    def init(self, params: Params, seed: int = 0) -> BridgeState:
        """The state at tick 0 from stacked ``params``, with the key
        ``PRNGKey(seed)``, a zero codec carry for a lossy codec, fresh trace
        aggregates for a ``trace``, an all-trusting state for a ``trust``
        (``[M, W]``: W = M dense, the table's K sparse) and an empty ring
        for a ``metrics`` spec."""
        m = self.config.topology.num_nodes
        for k, leaf in params.items():
            if leaf.shape[0] != m:
                raise ValueError(f"params[{k!r}] leading axis {leaf.shape[0]} != num_nodes {m}")
        params = {k: v.to(self.device) for k, v in params.items()}
        dim = stack_flatten(params)[0].shape[1]
        net = adv = None
        if self.runtime is not None:
            net = self.runtime.init(m, dim, max_wire_bits=self.codec.wire_bits(dim))
        if self.adversary is not None and self.adversary.stateful:
            adv = adv_lib.init_state(dim, lead=(), device=self.device)
        width = self.edge_width
        obs = obs_trace.init_state(self.config.trace, m, width, device=self.device)
        trust = trust_lib.init_state(self.config.trust, m, width, device=self.device)
        mets = obs_metrics.init_state(self.config.metrics, device=self.device)
        return BridgeState(params=params, t=0, key=prng.PRNGKey(seed),
                           comm=self.init_comm(params), net=net, adv=adv, obs=obs, trust=trust,
                           mets=mets)

    @property
    def edge_width(self) -> int:
        """W, the per-node edge slots of the trace's and the trust layer's
        ``[M, W]`` state: M dense, the neighbor table's K sparse."""
        nbr = self.neighbors if self.runtime is None else getattr(self.runtime, "neighbors", None)
        return self.config.topology.num_nodes if nbr is None else nbr.k

    def init_comm(self, params: Params) -> exchange.CommState | None:
        """The codec carry at tick 0: zero estimate and residual, ``[M, d]``
        per sender or, on the runtime path, ``[M, W, d]`` per link (``W`` is
        ``M`` dense, the runtime's table width sparse); None for a lossless
        codec."""
        w, _ = stack_flatten(params)
        m, dim = w.shape
        if self.runtime is None:
            return exchange.init_residual((m, dim), self.codec, device=self.device)
        nbr = getattr(self.runtime, "neighbors", None)
        link = m if nbr is None else nbr.k
        return exchange.init_residual((m, link, dim), self.codec, device=self.device)

    def _wire_roundtrip(self, sub: np.ndarray, x: torch.Tensor, comm, t: int):
        """The synchronous tick's wire stage (`wire_stage`) of ``x [M, d]``
        over the trainer's Byzantine senders under the host subkey ``sub``.
        A lossless codec under no wire attack skips the wire entirely (no
        ``+ 0.0`` anywhere), so the identity path is exactly the
        uncompressed trainer."""
        if self.codec.lossless and self.wire_attack.name == "none":
            return x, comm
        x_hat, new = wire_stage((self.codec,), (self.wire_attack,), self.cell,
                                np.asarray(sub, np.uint32)[None], x[None],
                                _cells(comm, lambda a: a[None]), self.byz_mask[None], t)
        return x_hat[0], _cells(new, lambda a: a[0])


# ---------------------------------------------------------------------------
# Contracts (`python -m repro_torch.analysis`)
# ---------------------------------------------------------------------------

CONTRACTS: tuple[Contract, ...] = (
    Contract(
        "bridge.prng.single_use", "prng",
        "no PRNG key feeds two distinct random draws without an intervening "
        "split/fold_in — per-edge wire-roundtrip and per-step subkey "
        "independence, checked on the keys a recorded tick draws with (flat, "
        "sparse, net, and metrics-on canonical programs)",
        params=(("programs", ("flat", "sparse", "net", "metrics")),),
    ),
    Contract(
        "bridge.salts.distinct", "lint",
        "the stream salts (attack / channel / codec / wire / adversary / "
        "trust) are pairwise distinct, so streams folded from one step "
        "subkey never correlate",
        params=(("check", "salts_distinct"),
                ("salts", ("NET_SALT", "COMM_SALT", "WIRE_SALT", "ADV_SALT",
                           "TRUST_SALT"))),
    ),
    Contract(
        "bridge.sparse.no_dense_mmd", "memory",
        "the sparse (neighbor-indexed) tick never creates a tensor as large "
        "as the dense [M, M, d] float layout it replaces (every op's new "
        "tensor seen by a dispatch mode; on the card also the allocator's "
        "peak over the bytes the tick leaves resident)",
        params=(("programs", ("sparse",)), ("budget", "dense_mmd")),
    ),
    Contract(
        "bridge.run_chunks.single_trace", "retrace",
        "a uniform-chunk run_chunks builds at most one entry in each of the "
        "port's build caches (the kernel library, the sorting networks, the "
        "tile and distance plans), and an identically-shaped re-run builds "
        "none",
        params=(("max_traces", 1),),
    ),
    Contract(
        "bridge.chunk_carry.donated", "memory",
        "run_chunks keeps no earlier tick's carry alive: the first tick's "
        "state tensors are freed by the chunk's end (and on the card the "
        "requested bytes grow by less than one carry over the chunk) — the "
        "port's form of the donated scan carry",
        params=(("check", "donation"),),
    ),
)
