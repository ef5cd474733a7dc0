"""The BRIDGE trainer — Algorithm 1 of the paper; port of the synchronous
broadcast path of `repro.core.bridge` (``build_cell_step`` with one codec
and no adversary, trace, trust or metrics spec, driven by
``BridgeTrainer``), on the dense or the sparse ``[M, K]`` layout.

All M node replicas live on one device as a stacked ``[M, ...]`` parameter
dict.  One tick, after ``key, sub = split(state.key)``:

1. **attack** — Byzantine rows of the broadcast ``w [M, d]`` are substituted
   (`repro_torch.core.byzantine`, keyed by ``sub``);
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
   subtract as in the reference.

Every random number comes from the reference's Threefry streams
(`repro_torch.prng`), so a seeded run follows the seeded reference run.

With ``runtime=`` (`repro_torch.net`) the tick is the reference's
network-runtime iteration (`build_cell_runtime_step`): the attack crafts
per-link messages (`byzantine.MessageAttack`), a lossy codec encodes each
link under its own keys ``fold_in(key, edge_id)`` with an ``[M, W, d]``
carry that advances on the tick's live edges only, the runtime moves the
messages (``exchange``), every node screens its mailbox views with
`screening.screen_views_banked` (the views kernels on the card), and a
node with fewer usable views than its rule's Table-II minimum keeps its
own value.

Both ticks are the reference's cell steps: `build_cell_step` (synchronous)
and `build_cell_runtime_step` (through a runtime) take stacked cells
(`CellParams`: rule and attack chosen from static banks, ``b``, the
Byzantine masks and the step-size schedule per cell, on a net grid the
scenario) and state ``[E, M, ...]``, and `BridgeTrainer.step` is their
E = 1 call with the trainer's one constant cell.  The batched grids
(`repro_torch.sim.engine`) run the same steps over many cells: every
screening kernel then launches once a tick for all of them.

PyTorch runs eagerly, so the reference's ``jit``/``scan`` machinery has no
counterpart: `BridgeTrainer.run` is a Python loop over `BridgeTrainer.step`.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.comm import codec as codec_lib
from repro_torch.comm import exchange
from repro_torch.core import byzantine, screening
from repro_torch.core.graph import Topology
from repro_torch.core.neighbors import NeighborTable, edge_id_grid
from repro_torch.device import resolve_device

Params = dict[str, torch.Tensor]

# Salts decorrelating the streams folded from one tick's subkey (the
# reference's `repro.core.bridge` constants; the port uses NET_SALT, COMM_SALT and
# WIRE_SALT).
NET_SALT = 0x6E657430
COMM_SALT = 0x636D6D30
WIRE_SALT = 0x77697230
ADV_SALT = 0x61647630
TRUST_SALT = 0x74727530

GRID_CODECS = ("a lossy codec or a wire attack over more than one cell: codecs and wire "
               "attacks on the grid are ROADMAP Queue 1 item 11's next step (open item 2)")


class BridgeState(NamedTuple):
    params: Params  # leaves with leading node axis [M, ...]
    t: int  # iteration counter
    key: np.ndarray  # Threefry key, two uint32 words (repro_torch.prng)
    # codec carry: [M, d] per sender on the broadcast path, [M, W, d] per
    # link on the runtime path; None for a lossless codec
    comm: exchange.CommState | None = None
    net: Any = None  # the runtime's state (mailboxes); None when synchronous


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
    ``CellParams`` rows): the rule and the attack as indices into the step's
    static banks, the Byzantine bound and step-size schedule per cell, the
    ``[E, M]`` Byzantine masks on the device and, on a net grid, each
    cell's network scenario as an index into the runtime's bank.  Indices,
    bounds and schedules stay on the host, where they pick the banks'
    branches and the step size without reading the card."""

    rule_idx: tuple[int, ...]
    attack_idx: tuple[int, ...]
    b: tuple[int, ...]
    byz_mask: torch.Tensor  # [E, M] bool
    lam: tuple[float, ...]
    t0: tuple[float, ...]
    lr: tuple[float, ...]
    scenario_idx: tuple[int, ...] = ()  # empty off a net grid

    @property
    def num_cells(self) -> int:
        return len(self.b)

    def select(self, cells) -> CellParams:
        """The rows ``cells`` (host indices) of every field."""
        cells = [int(i) for i in cells]
        pick = lambda xs: tuple(xs[i] for i in cells)
        mask = self.byz_mask.index_select(0, torch.as_tensor(cells, device=self.byz_mask.device))
        return CellParams(pick(self.rule_idx), pick(self.attack_idx), pick(self.b), mask,
                          pick(self.lam), pick(self.t0), pick(self.lr),
                          pick(self.scenario_idx) if self.scenario_idx else ())


@dataclasses.dataclass(frozen=True)
class BridgeConfig:
    """Graph, screening rule, threat model and step-size schedule of one
    trainer (the reference's fields for the main path)."""

    topology: Topology
    rule: str = "trimmed_mean"  # any of screening.RULES
    num_byzantine: int = 0  # the bound b given to the screening rule
    attack: str = "none"
    codec: str = "identity"  # wire codec (repro_torch.comm.codec.get_codec)
    byzantine_seed: int = 0
    lam: float = 1.0
    t0: float = 50.0
    lr: float = 0.0  # if > 0, a constant step size instead
    # neighbor-indexed [M, K] layout (repro_torch.core.neighbors): screening
    # reads each node's K table slots instead of masking all M rows
    sparse: bool = False

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
            stacked = stacked + perturb * prng.normal(leaf_keys[i], stacked.shape, stacked.device)
        out[k] = stacked
    return out


def cell_metrics(w_new: torch.Tensor, losses: torch.Tensor, honest: torch.Tensor, rho,
                 bits: float, live_edges, comm) -> dict:
    """The reference's diagnostics over the honest nodes of ``w_new``
    (``[M, d]``, or ``[E, M, d]`` with ``honest [E, M]``: one value a cell),
    with the codec's wire accounting over the live edges and the carry's
    residual norm."""
    cnt = torch.sum(honest, dim=-1).to(torch.float32)
    mu = torch.sum(torch.where(honest[..., None], w_new, 0.0), dim=-2) / cnt[..., None]
    dev = torch.where(honest[..., None], w_new - mu[..., None, :], 0.0)
    resid = 0.0 if comm is None else torch.sqrt(torch.sum(comm.resid * comm.resid))
    return {
        "loss": torch.sum(torch.where(honest, losses, 0.0), dim=-1) / cnt,
        "consensus_dist": torch.sqrt(torch.amax(torch.sum(dev * dev, dim=-1), dim=-1)),
        "rho": rho,
        "wire_bits_per_edge": bits,
        "wire_bytes_total": bits / 8.0 * live_edges,
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


def build_cell_step(grad_fn: Callable, adjacency: torch.Tensor, rules: tuple[str, ...],
                    attacks, *, neighbors: NeighborTable | None = None, codec=None,
                    wire_attack=None):
    """The synchronous-broadcast iteration over stacked cells:
    ``step(cell, state, batch) -> (state, metrics)``, the reference's
    ``build_cell_step`` with a rule bank ``rules``, an attack bank
    ``attacks`` (`byzantine.Attack`s) and ``cell`` a `CellParams` of E cells.

    ``state`` holds ``params`` ``[E, M, ...]``, the tick ``t`` all cells
    share and ``key`` the cells' host row keys ``[E, 2]``; ``grad_fn``
    takes the ``[E, M, ...]`` parameters and the tick's one batch and
    returns ``(losses [E, M], grads)``.  Screening is
    `screening.screen_all_banked` under the ``[M, M]`` ``adjacency`` or,
    with ``neighbors``, `screening.screen_gathered_banked`: each kernel
    launches once for the cells that chose its rule.  The metrics are
    ``[E]`` tensors (``rho`` a float32 ``[E]`` array).

    ``codec`` and ``wire_attack`` (the trainer's one cell) run the wire
    stage of `BridgeTrainer` for E = 1; a lossy codec or a wire attack over
    more cells raises (ROADMAP Queue 1 item 11, codecs on the grid).
    """
    codec = codec_lib.get_codec("identity") if codec is None else codec
    wire_attack = byzantine.WIRE_ATTACKS["none"] if wire_attack is None else wire_attack
    wired = not (codec.lossless and wire_attack.name == "none")
    n_edges = float(torch.sum(adjacency.to(torch.float32)))

    def screen(w_hat, w_bcast, cell):
        if neighbors is not None:
            return screening.screen_gathered_banked(w_hat, neighbors, rules, cell.rule_idx,
                                                    cell.b, self_vals=w_bcast)
        return screening.screen_all_banked(w_hat, adjacency, rules, cell.rule_idx, cell.b,
                                           self_vals=w_bcast)

    def step(cell: CellParams, state: BridgeState, batch) -> tuple[BridgeState, dict]:
        w, unflatten = stack_flatten(state.params, lead=2)
        e, _, d = w.shape
        keys = prng.split(state.key)  # [E, 2, 2] on the host
        key, sub = keys[:, 0], keys[:, 1]
        # (Steps 3-4) broadcast with Byzantine substitution
        with torch.profiler.record_function("bridge.attack"):
            w_bcast = apply_attack_bank(attacks, cell.attack_idx, w, cell.byz_mask, sub, state.t)
        # wire codec: what receivers decode (identity: w_bcast itself)
        comm = state.comm
        w_hat = w_bcast
        if wired:
            if e != 1:
                raise NotImplementedError(GRID_CODECS)
            with torch.profiler.record_function("bridge.codec"):
                x_hat, comm = wire_roundtrip(codec, wire_attack, sub[0], w_bcast[0], state.comm,
                                             cell.byz_mask[0], state.t)
                w_hat = x_hat[None]
        # (Step 5) screening at every node; self is the node's own broadcast,
        # which never travels the wire
        with torch.profiler.record_function("bridge.screen"):
            y = screen(w_hat, w_bcast, cell)
        # (Step 6) local gradient step at w_j(t)
        with torch.profiler.record_function("bridge.apply"):
            losses, grads = grad_fn(state.params, batch)
            g, _ = stack_flatten(grads, lead=2)
            rho = cell_step_size(cell.lam, cell.t0, cell.lr, state.t)
            w_new = y - _per_cell(rho, w.device) * g
            metrics = cell_metrics(w_new, losses, ~cell.byz_mask, rho,
                                   float(codec.wire_bits(d)), n_edges, comm)
        return BridgeState(unflatten(w_new), state.t + 1, key, comm), metrics

    return step


def _per_cell(rho: np.ndarray, device) -> float | torch.Tensor:
    """The step sizes as the update takes them: a float when every cell
    shares it (a grid's cells share t and, as in the reference's grids, the
    schedule), else ``[E, 1, 1]`` float32 on ``device``."""
    if np.all(rho == rho[0]):
        return float(rho[0])
    return torch.as_tensor(rho, device=device)[:, None, None]


def wire_roundtrip(codec, wire_attack, sub: np.ndarray, x: torch.Tensor, comm, byz: torch.Tensor,
                   t: int):
    """Encode -> codeword attack -> decode with error feedback, per sender,
    under ``fold_in(sub, COMM_SALT)`` and ``fold_in(sub, WIRE_SALT)``."""
    return codeword_roundtrip(codec, wire_attack, prng.fold_in(sub, COMM_SALT),
                              prng.fold_in(sub, WIRE_SALT), x, comm, byz, t)


def codeword_roundtrip(codec, wire_attack, comm_key, wire_key, x: torch.Tensor, comm,
                       byz: torch.Tensor, t: int):
    """Encode ``x [n, d]`` under ``comm_key``, corrupt the Byzantine rows'
    codewords under ``wire_key``, decode with the carry; the keys are host
    keys or ``[n, 2]`` row keys (`repro_torch.prng`)."""
    msg, target = exchange.encode(codec, comm_key, x, comm)
    msg = wire_attack(msg, byz, wire_key, t, x.shape[-1])
    return exchange.decode(codec, msg, target, comm, comm_key,
                           zero_folded=not wire_attack.rewrites_scale)


def link_roundtrip(codec, wire_attack, sub: np.ndarray, x: torch.Tensor, comm,
                   byz_link: torch.Tensor, t: int, edge_ids: torch.Tensor):
    """`wire_roundtrip` per link: the ``[M, W, d]`` messages flattened to
    ``[M W, d]`` rows, each encoded, attacked and decoded under its edge's
    keys ``fold_in(comm_key, edge_id)`` and ``fold_in(wire_key, edge_id)``
    (the reference's ``vmap`` over the edges), so the dense and the sparse
    layouts draw the same codewords on matching edges."""
    lead, d = x.shape[:-1], x.shape[-1]
    ids = edge_ids.reshape(-1)
    keys = [prng.fold_in(prng.fold_in(sub, salt), ids) for salt in (COMM_SALT, WIRE_SALT)]
    carry = None if comm is None else exchange.CommState(*(a.reshape(-1, d) for a in comm))
    x_hat, carry = codeword_roundtrip(codec, wire_attack, *keys, x.reshape(-1, d), carry,
                                      byz_link.reshape(-1), t)
    unrows = lambda a: a.reshape(*lead, d)
    return unrows(x_hat), (None if carry is None
                           else exchange.CommState(*(unrows(a) for a in carry)))


def _need(counts: np.ndarray, device) -> int | torch.Tensor:
    """The Table-II minimums ``[E]`` against usable counts ``[E, M]``: an
    int when every cell shares it, else an ``[E, 1]`` tensor (made once per
    distinct tuple, `screening.bound_arg`)."""
    arg = screening.bound_arg(tuple(int(c) for c in counts), device)
    return arg if isinstance(arg, int) else arg[:, None]


def build_cell_runtime_step(grad_fn: Callable, runtime, rules: tuple[str, ...],
                            message_attacks, *, codec=None, wire_attack=None):
    """The network-runtime iteration over stacked cells: ``step(cell,
    state, batch) -> (state, metrics)``, the reference's
    ``build_cell_runtime_step`` with a rule bank ``rules`` and a bank of
    `byzantine.MessageAttack`s.

    ``state`` holds ``params`` ``[E, M, ...]``, the tick ``t`` all cells
    share, ``key`` the cells' host row keys ``[E, 2]`` and ``net`` the
    runtime's state with a leading ``[E]`` axis.  The stages and keys are
    the reference's: ``key, sub = split(key)``; per-link messages and the
    self-views (`byzantine.messages_and_self_bank`, under ``sub``); the
    exchange under ``fold_in(sub, NET_SALT)``; every node screens its
    views (`screening.screen_views_banked`: the views kernels with the
    experiment axis on the card, one launch a rule for all the cells), and
    a node short of its rule's Table-II minimum keeps its own value; then
    the local gradient step.  The metrics are ``[E]``, the runtime's stats
    included.

    A runtime with ``cell_aware = True`` (`repro_torch.sim.engine.GridNetRuntime`)
    gets the cells, so it can pick each cell's scenario: ``adjacency_at(t,
    cell)`` and ``exchange(..., cell)``; the others keep their contract,
    one live mask for every cell.

    ``codec`` and ``wire_attack`` (the trainer's one cell) run the per-link
    codec stage for E = 1, the carry ``state.comm`` being that cell's
    ``[M, W, d]``; over more cells they raise (ROADMAP Queue 1 item 11,
    codecs on the grid).
    """
    codec = codec_lib.get_codec("identity") if codec is None else codec
    wire_attack = byzantine.WIRE_ATTACKS["none"] if wire_attack is None else wire_attack
    wired = not (codec.lossless and wire_attack.name == "none")
    cell_aware = bool(getattr(runtime, "cell_aware", False))
    nbr = getattr(runtime, "neighbors", None)

    def link_codec(sub, msgs, comm, adj_t, byz, t):
        """The codec per link of the one cell; a link's carry advances only
        for messages put on the wire this tick (live edges; channel drops
        are downstream)."""
        m = msgs.shape[0]
        if nbr is not None:
            byz_link, ids = nbr.gather_senders(byz, fill=False), nbr.edge_ids
        else:
            byz_link = byz[None, :].expand(m, m)
            ids = torch.as_tensor(edge_id_grid(m), device=msgs.device)
        x_hat, new = link_roundtrip(codec, wire_attack, sub, msgs, comm, byz_link, t, ids)
        if comm is not None and new is not comm:
            new = exchange.CommState(*(torch.where(adj_t[:, :, None], a, b)
                                       for a, b in zip(new, comm, strict=True)))
        return x_hat, new

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
        comm = state.comm
        if wired:
            if e != 1:
                raise NotImplementedError(GRID_CODECS)
            with torch.profiler.record_function("bridge.codec"):
                x_hat, comm = link_codec(sub[0], msgs[0], state.comm,
                                         adj_t[0] if adj_t.ndim == 3 else adj_t,
                                         cell.byz_mask[0], state.t)
                msgs = x_hat[None]
        with torch.profiler.record_function("bridge.exchange"):
            args = (state.net, msgs, w_self, adj_t, draw_key(prng.fold_in(sub, NET_SALT)),
                    state.t)
            kw = {"wire_bits": codec.wire_bits(d)}
            net, views, mask, net_stats = (runtime.exchange(*args, cell, **kw) if cell_aware
                                           else runtime.exchange(*args, **kw))
        # (Step 5) screening over the usable views; a node short of its
        # rule's Table-II minimum keeps its own value this tick
        with torch.profiler.record_function("bridge.screen"):
            y_rule = screening.screen_views_banked(views, mask, w_self, rules, cell.rule_idx,
                                                   cell.b)
            need = screening.min_neighbors_banked(rules, cell.rule_idx, cell.b)
            enough = mask.sum(dim=-1) >= _need(need, w.device)
            y = torch.where(enough[..., None], y_rule, w_self)
        # (Step 6) local gradient step at w_j(t)
        with torch.profiler.record_function("bridge.apply"):
            losses, grads = grad_fn(state.params, batch)
            g, _ = stack_flatten(grads, lead=2)
            rho = cell_step_size(cell.lam, cell.t0, cell.lr, state.t)
            w_new = y - _per_cell(rho, w.device) * g
            live = torch.sum(adj_t, dim=(-2, -1)).to(torch.float32).expand(e)
            metrics = cell_metrics(w_new, losses, ~cell.byz_mask, rho,
                                   float(codec.wire_bits(d)), live, comm)
        metrics.update(net_stats)
        metrics["screened_frac"] = torch.mean(enough.to(torch.float32), dim=-1)
        return BridgeState(unflatten(w_new), state.t + 1, key, comm, net), metrics

    return step


def _cells(net, fn):
    """``fn`` over every tensor of a runtime state (a NamedTuple of them,
    or None): adds or drops the cells' axis."""
    return None if net is None else type(net)(*(fn(x) for x in net))


def _one_cell(grad_fn: Callable) -> Callable:
    """A trainer's ``grad_fn`` (over ``[M, ...]``) as the cell step calls it,
    over one cell's ``[1, M, ...]``."""

    def fn(params: Params, batch):
        losses, grads = grad_fn({k: v[0] for k, v in params.items()}, batch)
        return losses[None], {k: v[None] for k, v in grads.items()}

    return fn


class BridgeTrainer:
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
        self.neighbors = None
        if runtime is None:
            self.attack = byzantine.get_attack(config.attack)
            if config.sparse:
                self.neighbors = NeighborTable.from_adjacency(adj, device=self.device)
            self._cell_step = build_cell_step(
                _one_cell(grad_fn), self.adjacency, (config.rule,), (self.attack,),
                neighbors=self.neighbors, codec=self.codec, wire_attack=self.wire_attack)
        else:
            self._check_runtime(runtime)
            self.message_attack = byzantine.get_message_attack(config.attack)
            self._cell_step = build_cell_runtime_step(
                _one_cell(grad_fn), runtime, (config.rule,), (self.message_attack,),
                codec=self.codec, wire_attack=self.wire_attack)
        self.byz_mask = byzantine.byzantine_nodes(config.topology.num_nodes, config.num_byzantine,
                                                  config.attack, config.byzantine_seed, self.device)
        self.cell = CellParams((0,), (0,), (config.num_byzantine,), self.byz_mask[None],
                               (config.lam,), (config.t0,), (config.lr,))

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
        ``PRNGKey(seed)`` and a zero codec carry for a lossy codec."""
        m = self.config.topology.num_nodes
        for k, leaf in params.items():
            if leaf.shape[0] != m:
                raise ValueError(f"params[{k!r}] leading axis {leaf.shape[0]} != num_nodes {m}")
        params = {k: v.to(self.device) for k, v in params.items()}
        net = None
        if self.runtime is not None:
            dim = stack_flatten(params)[0].shape[1]
            net = self.runtime.init(m, dim, max_wire_bits=self.codec.wire_bits(dim))
        return BridgeState(params=params, t=0, key=prng.PRNGKey(seed),
                           comm=self.init_comm(params), net=net)

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

    def step(self, state: BridgeState, batch: Any) -> tuple[BridgeState, dict]:
        """One tick: `build_cell_step`'s step (synchronous) or
        `build_cell_runtime_step`'s (through the runtime) over the
        trainer's one cell (E = 1).  The metrics are 0-d tensors on the
        device (reading one waits for the tick) and Python floats for the
        static quantities."""
        one = BridgeState({k: v[None] for k, v in state.params.items()}, state.t,
                          np.asarray(state.key, np.uint32)[None], state.comm,
                          _cells(state.net, lambda x: x[None]))
        new, metrics = self._cell_step(self.cell, one, batch)
        metrics = {k: (v[0] if isinstance(v, torch.Tensor) and v.ndim else
                       float(v[0]) if isinstance(v, np.ndarray) else v)
                   for k, v in metrics.items()}
        return BridgeState({k: v[0] for k, v in new.params.items()}, new.t, new.key[0],
                           new.comm, _cells(new.net, lambda x: x[0])), metrics

    def _wire_roundtrip(self, sub: np.ndarray, x: torch.Tensor, comm, t: int):
        """The synchronous tick's wire stage (`wire_roundtrip`) over the
        trainer's Byzantine senders.  A lossless codec under no wire attack
        skips the wire entirely (no ``+ 0.0`` anywhere), so the identity
        path is exactly the uncompressed trainer."""
        if self.codec.lossless and self.wire_attack.name == "none":
            return x, comm
        return wire_roundtrip(self.codec, self.wire_attack, sub, x, comm, self.byz_mask, t)

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
