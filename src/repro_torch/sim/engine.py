"""Batched experiment-grid engine — port of `repro.sim.engine`:
synchronous and network-scenario grids, dense and ``sparse=True``.

`GridEngine` lowers a list of `Cell`s to stacked ``[E, M, ...]`` state and
drives the *same* cell-parameterized step `BridgeTrainer` binds
(`repro_torch.core.bridge.build_cell_step`, or on a net grid
`build_cell_runtime_step`) over the experiment axis:

* rule, attack and scenario selection is data — host indices into static
  banks that hold only the distinct names the cells use;
* the Byzantine bound ``b``, the Byzantine masks, the keys and the
  step-size schedule ride along per cell;
* network scenarios stack their `repro_torch.net` mailbox state over E
  (`GridNetRuntime`: one mailbox ring sized for the slowest scenario, one
  exchange call a scenario over the cells that chose it).

* codecs and wire attacks: each cell encodes under its own keys, the carry
  ``[E, M, d]`` (per link ``[E, M, W, d]``) is stacked like the state, and
  a lossy dense codec decodes a group's rows in one ``dequant_carry``
  launch a tick;
* adversaries (`repro_torch.adversary`): the stacked ``AdvState`` ``[E, d]``
  (allocated only when the bank is stateful) and each cell's ``theta``
  ride along; ``inner_max`` ascends through the group's own screen;
* observability (`repro_torch.obs`): an engine-wide ``trace`` spec stacks
  its `TraceState` over ``[E]`` (each cell's per-edge trim counters and
  survival sums under forensics, its loss trace, reservoir and first
  non-finite tick; bit-inert; `sender_grid` names the edge slots), and an
  ``events`` log (`repro_torch.obs.EventLog`) receives the reference's
  ``run.start``, ``grid.chunk``, ``run.end`` and ``obs.divergence``
  records;
* the trust layer (`repro_torch.trust`): an engine-wide ``trust`` spec
  stacks its `TrustState` over ``[E]``; each cell's evictions clear its own
  mask, which the screening kernels take per cell, and ``slander``'s
  forged digests reach the net grids' echo stage;
* live metrics (`repro_torch.obs.metrics`): an engine-wide ``metrics``
  spec stacks each cell's ring over ``[E]`` (bit-inert), and
  ``run(..., metric_writer=)`` flushes every cell's ring under its tag,
  as each chunk of cells finishes or at the end.

The screening kernels take the experiment axis (`repro_torch.kernels`):
each launches once a tick for a group of cells, whatever its size.  Since
real sweeps are (near-)products, the engine **groups** cells with equal
(rule, attack, adversary, codec) (``group=True``, the default): each group
runs the single-entry-bank step; ``group=False`` runs one banked step over
every cell, in which each rule, attack, codec and adversary runs once over
the cells that chose it.  Cells run group-major internally and results
come back in the caller's order.  With several lossy codecs in one banked
step a cell may differ from its grouped twin (the reference allows about
1 ulp a tick there, its codewords padded to the bank's largest); grouped
cells are bit for bit their trainers'.

``chunk`` bounds memory: each group's cells run ``chunk`` at a time, the
ragged last chunk padded with copies of its final cell and trimmed.

PyTorch runs eagerly, so the reference's ``trace_count`` (compilations,
one per group) has no counterpart: the engine builds one step per group
(``num_steps_built``, fixed for the engine's life, `set_cells` included)
and counts the group steps it runs (``step_calls``, one per group, chunk
and tick).

Correctness anchor, as in the reference: any single cell equals its own
`BridgeTrainer` run bit for bit (``tests/test_torch_grid.py`` on the CPU,
``chip_smoke.py`` on the card).
"""
from __future__ import annotations

import time
from collections.abc import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.adversary import protocols as adv_lib
from repro_torch.comm import codec as codec_lib
from repro_torch.comm import exchange
from repro_torch.core import byzantine as byz_lib
from repro_torch.core.bridge import (BridgeState, CellParams, build_cell_runtime_step,
                                     build_cell_step, stack_batches, stack_flatten)
from repro_torch.core.neighbors import NeighborTable
from repro_torch.device import resolve_device, wait
from repro_torch.net import mailbox as mb
from repro_torch.net.runtime import SparseUnreliableRuntime, UnreliableRuntime
from repro_torch.net.scenarios import build_schedule, get_scenario
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.sim import grid as grid_lib
from repro_torch.sim.grid import Cell, ExperimentGrid
from repro_torch.trust import reputation as trust_lib

__all__ = ["GridEngine", "GridNetRuntime", "stack_batches"]


def _dedup(names: Iterable) -> list:
    out = []
    for n in names:
        if n not in out:
            out.append(n)
    return out


def _check_cell(c: Cell) -> None:
    """Each of the cell's names resolves, and its theta has `THETA_DIM`
    entries."""
    codec_lib.get_codec(c.codec)
    adv_lib.get_adversary(c.adversary)
    if c.theta is not None and len(c.theta) != adv_lib.THETA_DIM:
        raise ValueError(f"cell {c.tag}: theta must have {adv_lib.THETA_DIM} entries")


def _take(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Rows ``sel`` of the cells' axis of ``x``; per-link messages with a
    receiver stride of 0 (a lifted broadcast) stay expanded."""
    if x.ndim == 4 and x.stride(1) == 0:
        return x[:, 0].index_select(0, sel)[:, None].expand(-1, *x.shape[1:])
    return x.index_select(0, sel)


class GridNetRuntime:
    """A scenario-banked network runtime: the reference's ``GridNetRuntime``
    over the port's runtimes.

    Holds one `repro_torch.net.runtime.UnreliableRuntime` (or, ``sparse``,
    `SparseUnreliableRuntime`) per distinct scenario, each with its
    full-length ``[T, M, M]`` schedule (`build_schedule` under ``seed``).
    The cells' mailbox state is stacked, ``[E, M, W, L, d]``, with one ring
    sized for the largest latency in the bank: ring semantics are invariant
    to extra capacity, so each cell stays its dedicated runtime's, bit for
    bit up to the sign of a zero (`repro_torch.net.mailbox.deliver` adds
    ``0.0`` to a payload when ``L > 1``).  `exchange` runs once a scenario
    over the cells that chose it (``cell.scenario_idx``), each cell's
    channel drawn under its own key, and scatters the results back.  In
    sparse mode every scenario shares one `NeighborTable` over the union of
    all their schedules, so every cell has the same ``[M, K]`` layout;
    slots a scenario never uses are inert.
    """

    cell_aware = True  # the step hands it the cells (build_cell_runtime_step)

    def __init__(self, topology, scenarios: Sequence[str], num_ticks: int, *, seed: int = 0,
                 sparse: bool = False, device: str | torch.device = "cuda"):
        if not scenarios:
            raise ValueError("GridNetRuntime needs at least one scenario")
        self.device = resolve_device(device)
        self.scenario_names = tuple(scenarios)
        self._specs = [get_scenario(n) for n in self.scenario_names]
        self.num_ticks = int(num_ticks)
        scheds = [np.asarray(build_schedule(s, topology, self.num_ticks, seed=seed), bool)
                  for s in self._specs]
        self._schedules_np = np.stack(scheds)  # [S, T, M, M]
        self.neighbors = None
        if sparse:
            self.neighbors = NeighborTable.from_schedule(np.concatenate(scheds, axis=0),
                                                         device=self.device)
            self._runtimes = tuple(SparseUnreliableRuntime(
                sched, s.channel, staleness_bound=s.staleness_bound, neighbors=self.neighbors,
                device=self.device) for s, sched in zip(self._specs, scheds, strict=True))
        else:
            self._runtimes = tuple(UnreliableRuntime(
                sched, s.channel, staleness_bound=s.staleness_bound, device=self.device)
                for s, sched in zip(self._specs, scheds, strict=True))
        # every scenario's live masks, [S, T, M, W] on the device
        self._lives = torch.stack([rt._schedule for rt in self._runtimes])
        self._index: dict[tuple[int, ...], torch.Tensor] = {}

    def schedule_for(self, name: str) -> np.ndarray:
        """The exact ``[T, M, M]`` schedule a sequential comparator run must
        use to reproduce this runtime's cell bit for bit."""
        return self._schedules_np[self.scenario_names.index(name)]

    def _scenarios(self, cell: CellParams) -> list[int]:
        return sorted(set(cell.scenario_idx))

    def adjacency_at(self, t: int, cell: CellParams) -> torch.Tensor:
        """The tick's live mask of each cell's scenario: ``[M, W]`` when the
        cells share one scenario, else ``[E, M, W]``."""
        used = self._scenarios(cell)
        if len(used) == 1:
            return self._runtimes[used[0]].adjacency_at(t)
        idx = self._index.get(cell.scenario_idx)
        if idx is None:
            idx = self._index[cell.scenario_idx] = torch.as_tensor(
                cell.scenario_idx, dtype=torch.int64, device=self.device)
        return self._lives[:, t % self.num_ticks].index_select(0, idx)

    def init(self, num_nodes: int, dim: int, max_wire_bits: int | None = None, *,
             lead: tuple[int, ...] = ()) -> mb.MailboxState:
        """Empty mailboxes, ``lead`` cells of them, with the ring sized for
        the slowest scenario's worst case (propagation plus the
        serialization of the largest codeword of the codec bank,
        `exchange.max_wire_bits`; a float32 payload by default)."""
        bits = 32 * dim if max_wire_bits is None else max_wire_bits
        ring = max(s.channel.max_total_latency(bits) for s in self._specs)
        width = None if self.neighbors is None else self.neighbors.k
        return mb.init_mailbox(num_nodes, dim, ring, width=width, lead=lead, device=self.device)

    def exchange(self, net_state, msgs, self_vals, adjacency, key, t, cell: CellParams, *,
                 wire_bits=None):
        """Each cell's exchange through its scenario's runtime: ``msgs [E,
        M, W, d]``, ``key`` one key (E = 1) or the cells' host row keys
        ``[E, 2]``, ``wire_bits`` an int or one a cell (a mixed codec
        bank); returns the stacked state, the views ``[E, M, W, d]``, the
        usable masks ``[E, M, W]`` and ``[E]`` stats.  One exchange runs
        per (scenario, wire bits) the cells use."""
        e = len(cell.scenario_idx)
        bits = (np.asarray(wire_bits, np.int64) if isinstance(wire_bits, tuple)
                else np.full((e,), -1 if wire_bits is None else wire_bits, np.int64))
        pairs = sorted(set(zip(cell.scenario_idx, bits.tolist())))
        as_bits = lambda b: None if b < 0 else int(b)
        if len(pairs) == 1:
            s, b = pairs[0]
            return self._runtimes[s].exchange(net_state, msgs, self_vals, adjacency, key,
                                              t, wire_bits=as_bits(b))
        keys = np.asarray(key, np.uint32).reshape(-1, 2)
        idx = np.asarray(cell.scenario_idx, np.int64)
        state_out = mask_out = stats_out = None
        for s, b in pairs:
            cells = np.nonzero((idx == s) & (bits == b))[0]
            sel = torch.as_tensor(cells, device=self.device)
            part = type(net_state)(*(x.index_select(0, sel) for x in net_state))
            adj = adjacency.index_select(0, sel) if adjacency.ndim == 3 else adjacency
            k = keys[cells[0]] if len(cells) == 1 else keys[cells]
            new, _, mask, stats = self._runtimes[s].exchange(
                part, _take(msgs, sel), self_vals.index_select(0, sel), adj, k, t,
                wire_bits=as_bits(b))
            if state_out is None:
                state_out = type(net_state)(*(torch.empty_like(x) for x in net_state))
                mask_out = torch.empty((idx.shape[0], *mask.shape[1:]), dtype=mask.dtype,
                                       device=mask.device)
                stats_out = {k_: torch.empty((idx.shape[0],), dtype=v.dtype, device=v.device)
                             for k_, v in stats.items()}
            for out, x in zip(state_out, new, strict=True):
                out.index_copy_(0, sel, x)
            mask_out.index_copy_(0, sel, mask)
            for k_, v in stats.items():
                stats_out[k_].index_copy_(0, sel, v.reshape(-1))
        return state_out, state_out.values, mask_out, stats_out


def _rows(net, fn):
    """``fn`` over every tensor of a stacked carry (or None)."""
    return None if net is None else type(net)(*(fn(x) for x in net))


class GridEngine:
    """Runs a list of grid `Cell`s over stacked state, one step per group.

    ``cells`` defaults to the grid's full cross product; a resumable sweep
    passes the not-yet-computed subset.  All cells must be on the same side
    of the sync/net split (their state differs); ``num_ticks`` is required
    for net grids (the schedules' length, drawn under ``scenario_seed``),
    which carry their stacked mailboxes in ``state.net``.  ``grad_fn(params, batch)`` takes
    the ``[E, M, ...]`` parameters of a group's cells and the tick's one
    batch (shared by every cell, as in the reference) and returns
    ``(losses [E, M], grads)`` (`repro_torch.models.small.linear_loss_and_grad`
    does).  ``sparse=True`` screens through the topology's `NeighborTable`
    (the gather kernels), each cell bit-identical to its dense twin.

    ``trace`` (a `repro_torch.obs.TraceSpec`) carries each cell's
    aggregates in ``state.obs``, ``trust`` (a `repro_torch.trust.TrustSpec`)
    each cell's trust state in ``state.trust``, ``metrics`` (a
    `repro_torch.obs.MetricSpec`) each cell's metric ring in
    ``state.mets``; ``events`` (an `EventLog`) gets the run's records.

    Usage — a rule x attack x seed product::

        grid = ExperimentGrid(topology, rules=("trimmed_mean", "median"),
                              attacks=("random", "alie"),
                              byzantine_counts=(1,), seeds=(0, 1, 2, 3))
        engine = GridEngine(grid, grad_fn)
        final, metrics = engine.run(engine.init(init_fn), batches)
        losses = metrics["loss"]        # [E, T], ordered like engine.cells
    """

    def __init__(self, grid: ExperimentGrid, grad_fn: Callable, *,
                 cells: Sequence[Cell] | None = None, num_ticks: int | None = None,
                 scenario_seed: int = 0, group: bool = True, sparse: bool = False, trace=None,
                 trust=None, metrics=None, events=None, device: str | torch.device = "cuda"):
        self._trace_spec = trace
        self._trust_spec = trust
        self._metric_spec = metrics
        self._events = events
        self.device = resolve_device(device)
        self.grid = grid
        self.cells = list(cells) if cells is not None else grid.cells()
        if not self.cells:
            raise ValueError("no cells to run")
        for c in self.cells:
            _check_cell(c)
        scen = [c.scenario for c in self.cells]
        if any(s is None for s in scen) != all(s is None for s in scen):
            raise ValueError("cannot mix synchronous and net-scenario cells in one grid batch "
                             "(their carried state differs); split into two grids")
        self.net_mode = scen[0] is not None
        topo = grid.topology
        self.rule_bank = _dedup(c.rule for c in self.cells)
        self.attack_bank = _dedup(c.attack for c in self.cells)
        self.scenario_bank = _dedup(s for s in scen if s is not None)
        self.codec_bank = _dedup(c.codec for c in self.cells)
        self.adversary_bank = _dedup(c.adversary for c in self.cells)
        # the adversary stage engages only when some cell names one
        self._adv_engaged = any(c.adversary != "none" for c in self.cells)
        self._adv_stateful = self._adv_engaged and adv_lib.bank_stateful(
            adv_lib.adversary_bank(self.adversary_bank))
        self.sparse = bool(sparse)
        self._adjacency = torch.as_tensor(topo.adjacency, dtype=torch.bool, device=self.device)
        self.runtime = None
        if self.net_mode:
            if num_ticks is None:
                raise ValueError("num_ticks is required for net-scenario grids (schedule length)")
            self.runtime = GridNetRuntime(topo, self.scenario_bank, num_ticks,
                                          seed=scenario_seed, sparse=self.sparse,
                                          device=self.device)
            self.neighbors = self.runtime.neighbors
        else:
            self.neighbors = (NeighborTable.from_adjacency(topo.adjacency, device=self.device)
                              if self.sparse else None)
        self._group = bool(group)
        e = len(self.cells)
        gkey = self._group_keys(self.cells)
        self._perm = np.asarray(sorted(range(e), key=lambda i: gkey[i]), np.int64)
        self._inv = np.argsort(self._perm)
        self._bounds: list[tuple[int, int]] = []
        self._steps: list[Callable] = []
        self._banks: list[tuple[tuple[str, ...], ...]] = []
        lo = 0
        for i in range(1, e + 1):
            if i == e or gkey[self._perm[i]] != gkey[self._perm[lo]]:
                head = self.cells[self._perm[lo]]
                banks = (((head.rule,), (head.attack,), (head.codec,), (head.adversary,))
                         if self._group else
                         (tuple(self.rule_bank), tuple(self.attack_bank), tuple(self.codec_bank),
                          tuple(self.adversary_bank)))
                self._banks.append(banks)
                self._steps.append(self._build_step(grad_fn, *banks))
                self._bounds.append((lo, i))
                lo = i
        self.step_calls = 0
        self._bind_cells(self.cells)

    @property
    def num_cells(self) -> int:
        return len(self.cells)

    @property
    def num_steps_built(self) -> int:
        """Steps the engine built: one per group (the reference's
        compilations)."""
        return len(self._steps)

    def _build_step(self, grad_fn, rules, attacks, codecs, adversaries) -> Callable:
        """One group's step over its banks (the adversary stage only when a
        cell of the engine names one)."""
        kw = dict(codecs=codecs, wire_attacks=byz_lib.wire_attack_bank(attacks),
                  adversaries=adversaries if self._adv_engaged else None,
                  trace=self._trace_spec, trust=self._trust_spec)
        if self.net_mode:
            return build_cell_runtime_step(
                grad_fn, self.runtime, rules,
                tuple(byz_lib.get_message_attack(a) for a in attacks), **kw)
        return build_cell_step(grad_fn, self._adjacency, rules,
                               tuple(byz_lib.get_attack(a) for a in attacks),
                               neighbors=self.neighbors, **kw)

    def _group_keys(self, cells) -> list[tuple[int, ...]]:
        if not self._group:
            return [(0, 0, 0, 0)] * len(cells)
        return [(self.rule_bank.index(c.rule), self.attack_bank.index(c.attack),
                 self.adversary_bank.index(c.adversary), self.codec_bank.index(c.codec))
                for c in cells]

    def _bind_cells(self, cells) -> None:
        """Stack per-cell parameters (Byzantine masks, bank indices, bounds,
        adversary thetas, schedules) into the `CellParams` rows the steps
        read, and each group's rows in its own banks' indices."""
        m = self.grid.topology.num_nodes
        e = len(cells)
        self.byz_masks = np.stack(
            [grid_lib.pick_byz_mask(m, c, self.grid.byzantine_seed) for c in cells])
        g = self.grid
        adv_idx, adv_theta = (), None
        if self._adv_engaged:
            adv_idx = tuple(self.adversary_bank.index(c.adversary) for c in cells)
            adv_theta = np.asarray([c.theta if c.theta is not None
                                    else adv_lib.get_adversary(c.adversary).default_theta
                                    for c in cells], np.float32)
        self._cell_stack = CellParams(
            rule_idx=tuple(self.rule_bank.index(c.rule) for c in cells),
            attack_idx=tuple(self.attack_bank.index(c.attack) for c in cells),
            b=tuple(int(c.b) for c in cells),
            byz_mask=torch.as_tensor(self.byz_masks, device=self.device),
            lam=(g.lam,) * e, t0=(g.t0,) * e, lr=(g.lr,) * e,
            scenario_idx=(tuple(self.scenario_bank.index(c.scenario) for c in cells)
                          if self.net_mode else ()),
            codec_idx=tuple(self.codec_bank.index(c.codec) for c in cells),
            adv_idx=adv_idx, adv_theta=adv_theta, metrics=self._metric_spec)
        self._group_cells = []
        for (rules, attacks, codecs, advs), (lo, hi) in zip(self._banks, self._bounds,
                                                            strict=True):
            idx = self._perm[lo:hi]
            rows = self._cell_stack.select(idx)
            self._group_cells.append(rows._replace(
                rule_idx=tuple(rules.index(cells[i].rule) for i in idx),
                attack_idx=tuple(attacks.index(cells[i].attack) for i in idx),
                codec_idx=tuple(codecs.index(cells[i].codec) for i in idx),
                adv_idx=(tuple(advs.index(cells[i].adversary) for i in idx)
                         if self._adv_engaged else ())))

    def set_cells(self, cells: Sequence[Cell]) -> None:
        """Swap the engine onto a new cell list of identical *structure* —
        same length and same per-position (rule, attack, adversary, codec)
        group keys — keeping its steps (the reference keeps its compiled
        programs).  Everything that changed (b, seeds, Byzantine masks,
        adversary thetas) is data the next `run` reads."""
        cells = list(cells)
        if len(cells) != len(self.cells):
            raise ValueError(
                f"set_cells needs {len(self.cells)} cells (engine shape), got {len(cells)}")
        for c in cells:
            for bank, name, axis in ((self.rule_bank, c.rule, "rule"),
                                     (self.attack_bank, c.attack, "attack"),
                                     (self.adversary_bank, c.adversary, "adversary"),
                                     (self.codec_bank, c.codec, "codec")):
                if name not in bank:
                    raise ValueError(
                        f"set_cells: {axis} {name!r} is outside this engine's "
                        f"bank {bank}; rebuild a GridEngine to change the grid's structure")
            if c.scenario is not None and c.scenario not in self.scenario_bank:
                raise ValueError(f"set_cells: scenario {c.scenario!r} is outside this engine's "
                                 f"bank {self.scenario_bank}")
            if (c.scenario is None) == self.net_mode:
                raise ValueError("set_cells cannot move cells across the sync/net split")
        if not self._adv_engaged and any(c.adversary != "none" for c in cells):
            raise ValueError("set_cells: this engine was built without the adversary stage "
                             "(every cell was adversary='none'); rebuild a GridEngine to add one")
        for c in cells:
            if c.theta is not None and len(c.theta) != adv_lib.THETA_DIM:
                raise ValueError(f"cell theta must have {adv_lib.THETA_DIM} entries")
        if self._group_keys(self.cells) != self._group_keys(cells):
            raise ValueError(
                "set_cells cells must keep the per-position (rule, attack, "
                "adversary, codec) group keys; rebuild a GridEngine to change "
                "the grid's structure")
        old_cells = self.cells
        try:
            self.cells = cells
            self._bind_cells(cells)
        except Exception:
            self.cells = old_cells
            self._bind_cells(old_cells)
            raise

    def init(self, init_fn: Callable[[int], dict]) -> BridgeState:
        """Stack per-cell initial states.  ``init_fn(seed) -> [M, ...]``
        parameters must be exactly what the sequential trainer would be
        handed: cells with equal seeds share initial replicas, and each
        cell's key is ``PRNGKey(seed)``, as ``BridgeTrainer.init(params,
        seed=seed)`` takes it.  A net grid's cells start with empty
        mailboxes, ``[E, M, W, L, d]``, the ring sized for the bank's largest
        codeword.  A lossy codec bank adds the zero codec carry (``[E, M,
        d]``, per link ``[E, M, W, d]``) for every cell, a stateful
        adversary bank the zero ``AdvState`` ``[E, d]``, a ``trace`` fresh
        `TraceState` rows ``[E, ...]``, a ``trust`` all-trusting
        `TrustState` rows ``[E, M, W]``, a ``metrics`` spec empty rings
        ``[E, C, S]``."""
        m = self.grid.topology.num_nodes
        params = [init_fn(c.seed) for c in self.cells]
        for k, leaf in params[0].items():
            if leaf.shape[0] != m:
                raise ValueError(f"init_fn params[{k!r}] leading axis {leaf.shape[0]} != "
                                 f"num_nodes {m}")
        stacked = {k: torch.stack([p[k].to(self.device) for p in params]) for k in params[0]}
        keys = np.stack([prng.PRNGKey(c.seed) for c in self.cells])
        e = len(self.cells)
        dim = stack_flatten(params[0])[0].shape[1]
        bank = codec_lib.codec_bank(self.codec_bank)
        net = None
        shape = (e, m, dim)
        if self.runtime is not None:
            net = self.runtime.init(m, dim, exchange.max_wire_bits(bank, dim), lead=(e,))
            shape = (e, m, m if self.neighbors is None else self.neighbors.k, dim)
        comm = exchange.init_residual(shape, bank, device=self.device)
        adv = (adv_lib.init_state(dim, lead=(e,), device=self.device) if self._adv_stateful
               else None)
        width = m if self.neighbors is None else self.neighbors.k
        obs = obs_trace.init_state(self._trace_spec, m, width, lead=(e,), device=self.device)
        trust = trust_lib.init_state(self._trust_spec, m, width, lead=(e,), device=self.device)
        mets = obs_metrics.init_state(self._metric_spec, lead=(e,), device=self.device)
        return BridgeState(params=stacked, t=0, key=keys, comm=comm, net=net, adv=adv, obs=obs,
                           trust=trust, mets=mets)

    def run(self, state: BridgeState, batches, *, chunk: int | None = None,
            metric_writer=None):
        """Run every cell over ``batches`` (a tensor or a tuple of tensors
        ``[T, ...]``, shared across cells; `stack_batches` makes them).
        Returns ``(final_state, metrics)`` with state leaves ``[E, ...]`` and
        metric leaves ``[E, T]`` (tensors on the engine's device), in the
        order of ``self.cells``.  With an ``events`` log: ``run.start``, a
        ``grid.chunk`` per chunk when ``chunk`` splits the cells (each
        chunk waited for, so its wall time is its work), ``run.end`` and an
        ``obs.divergence`` per cell whose sentinel fired.

        ``metric_writer`` (a `repro_torch.obs.MetricWriter`; needs the
        engine's ``metrics`` spec) gets each cell's ring under the cell's
        tag: as each chunk of cells finishes when ``chunk`` splits them,
        else once at the end.  A ring holds a cell's last ``capacity``
        ticks, so a grid's streams are that tail (a trainer's `run_chunks`
        streams every tick)."""
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if metric_writer is not None and self._metric_spec is None:
            raise ValueError("metric_writer needs GridEngine(..., metrics=MetricSpec(...))")
        ticks = int((batches[0] if isinstance(batches, (tuple, list)) else batches).shape[0])
        ev = self._events
        chunked = chunk is not None and chunk < self.num_cells
        t_run = time.perf_counter()
        if ev is not None:
            ev.emit("run.start", kind="grid", cells=self.num_cells, ticks=ticks, chunk=chunk,
                    groups=len(self._bounds), sparse=self.sparse,
                    traced=self._trace_spec is not None)
        tick = (lambda i: tuple(b[i] for b in batches)) if isinstance(batches, (tuple, list)) \
            else (lambda i: batches[i])
        keys = np.asarray(state.key, np.uint32)
        finals, metrics = [], []
        for gi, (glo, ghi) in enumerate(self._bounds):
            width = ghi - glo if chunk is None else min(chunk, ghi - glo)
            for lo in range(glo, ghi, width):
                hi = min(lo + width, ghi)
                # pad a ragged chunk with copies of its last cell, trimmed below
                rows = np.concatenate([np.arange(lo, hi), np.full(width - (hi - lo), hi - 1)])
                cells_idx = self._perm[rows]
                sel = torch.as_tensor(cells_idx, device=self.device)
                cp = self._group_cells[gi].select(rows - glo)
                take = lambda x: x.index_select(0, sel)
                st = BridgeState({k: take(v) for k, v in state.params.items()}, state.t,
                                 keys[cells_idx], _rows(state.comm, take),
                                 _rows(state.net, take), _rows(state.adv, take),
                                 _rows(state.obs, take), _rows(state.trust, take),
                                 _rows(state.mets, take))
                t_chunk = time.perf_counter()
                f, ms = self._run_chunk(self._steps[gi], cp, st, tick, ticks)
                if ev is not None and chunked:
                    wait(self.device)
                    ev.emit("grid.chunk", group=gi, lo=int(lo), hi=int(hi),
                            wall_s=time.perf_counter() - t_chunk)
                valid = hi - lo
                trim = lambda x: x[:valid]
                finals.append(BridgeState({k: v[:valid] for k, v in f.params.items()}, f.t,
                                          f.key[:valid], _rows(f.comm, trim), _rows(f.net, trim),
                                          _rows(f.adv, trim), _rows(f.obs, trim),
                                          _rows(f.trust, trim), _rows(f.mets, trim)))
                if metric_writer is not None and chunked:
                    metric_writer.flush(finals[-1].mets,
                                        tags=[self.cells[i].tag for i in self._perm[lo:hi]])
                metrics.append({k: v[:valid] for k, v in ms.items()})
        order = torch.as_tensor(self._inv, device=self.device)
        params = {k: torch.cat([f.params[k] for f in finals]).index_select(0, order)
                  for k in state.params}
        key = np.concatenate([f.key for f in finals])[self._inv]

        def carried(field: str):
            if getattr(state, field) is None:
                return None
            parts = [getattr(f, field) for f in finals]
            return type(parts[0])(*(torch.cat(xs).index_select(0, order)
                                    for xs in zip(*parts, strict=True)))

        out = {k: torch.cat([ms[k] for ms in metrics]).index_select(0, order)
               for k in metrics[0]}
        final = BridgeState(params=params, t=finals[0].t, key=key, comm=carried("comm"),
                            net=carried("net"), adv=carried("adv"), obs=carried("obs"),
                            trust=carried("trust"), mets=carried("mets"))
        if metric_writer is not None and not chunked:
            metric_writer.flush(final.mets, tags=[c.tag for c in self.cells])
        if ev is not None:
            wait(self.device)
            ev.emit("run.end", kind="grid", wall_s=time.perf_counter() - t_run,
                    trace_count=self.num_steps_built)
            if final.obs is not None and self._trace_spec.sentinel:
                for i, tick in enumerate(final.obs.first_bad.cpu().tolist()):
                    if tick >= 0:
                        ev.emit("obs.divergence", cell=self.cells[i].tag, first_bad_tick=tick)
        return final, out

    def _run_chunk(self, step: Callable, cell: CellParams, state: BridgeState, tick: Callable,
                   ticks: int) -> tuple[BridgeState, dict]:
        """``ticks`` ticks of one group's chunk; its metrics ``[E_c, T]``."""
        streams: dict[str, list] = {}
        for i in range(ticks):
            state, ms = step(cell, state, tick(i))
            self.step_calls += 1
            for k, v in ms.items():
                streams.setdefault(k, []).append(v)
        e = cell.num_cells
        out = {}
        for k, vals in streams.items():
            if isinstance(vals[0], torch.Tensor) and vals[0].ndim:
                out[k] = torch.stack(vals, dim=1)
            else:  # host values: per-cell arrays or one value a tick
                host = np.stack([np.broadcast_to(np.asarray(
                    v.cpu() if isinstance(v, torch.Tensor) else v, np.float32), (e,))
                    for v in vals], axis=1)
                out[k] = torch.as_tensor(host, device=self.device)
        return state, out

    def cell_params_of(self, i: int) -> CellParams:
        """Row ``i`` of the stacked cell parameters (diagnostics/tests)."""
        return self._cell_stack.select([i])

    def sender_grid(self) -> np.ndarray:
        """``[M, W]`` sender node id per edge slot (-1 = never live), what
        `repro_torch.obs.trace.summarize` and `repro_torch.trust.summarize`
        need to name edges: the table's slots sparse; on a dense net grid
        every slot (schedules vary by tick), on a synchronous one the
        adjacency's."""
        m = self.grid.topology.num_nodes
        if self.neighbors is not None:
            return obs_trace.sender_grid(m, neighbors=self.neighbors)
        return obs_trace.sender_grid(
            m, adjacency=None if self.net_mode else self.grid.topology.adjacency)
