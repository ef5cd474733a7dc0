"""The five canonical programs the contract gate checks — port of
`repro.analysis.programs`, with the reference's graphs, rules, attacks,
codecs, seeds and quadratic workloads:

* ``flat``    — dense broadcast path, a *drawing* attack (``random``) plus the
  int8 wire codec, so the tick's key tree is maximally populated;
* ``sparse``  — neighbor-indexed layout on a genuinely sparse graph
  (max degree + 1 < M), where the dense ``[M, M, d]`` budget has headroom
  and any dense materialization is a real violation, not the gather;
* ``stream``  — the chunk-streaming trainer over a two-leaf model, whose
  largest tensor must stay under the flat ``[M, d]`` it replaces;
* ``net``     — the unreliable-runtime path (drops + staleness), whose
  per-edge channel draws stress the PRNG discipline hardest;
* ``metrics`` — the flat program with the live-metric ring; its tick must
  pass exactly one more fence site than ``flat``'s (the gradient norm's).

Each builder takes ``device`` and keyword sizes, defaulting to the
reference's (M = 8, d = 5; sparse M = 12, d = 16; stream leaves 512 + 256
at ``screen_chunk`` 64), so a caller can check the same program at the
main path's widths.  What the passes read is measured on one tick from the
program's initial state, lazily and once a program: the keys it drew
(`key_record`), the fence sites it passed and the apply's bits
(`fence_record`), its largest tensor and peak (`memory_record`).
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable
from typing import Any

import torch

from repro_torch import prng
from repro_torch.analysis import fence as fence_pass
from repro_torch.analysis import memory as memory_pass
from repro_torch.analysis import prng as prng_pass
from repro_torch.core.bridge import BridgeConfig, BridgeTrainer, replicate, stack_batches
from repro_torch.core.graph import Topology, erdos_renyi
from repro_torch.device import resolve_device

#: bytes per f32 element
_F32 = 4


def quad_grad_fn(params, batch):
    """The analysis workload: each node's quadratic pull toward its row of
    ``batch`` (``[.., M, d]``; the grids' ``[E, M, d]`` parameters too)."""
    diff = params["w"] - batch
    return 0.5 * torch.sum(diff * diff, dim=-1), {"w": diff}


def two_leaf_grad_fn(params, batch):
    """Stream-path workload: two leaves so the block schedule is nontrivial."""
    loss = 0.0
    grads = {}
    for name in sorted(params):
        diff = params[name] - batch[name]
        loss = loss + 0.5 * torch.sum(diff * diff, dim=-1)
        grads[name] = diff
    return loss, grads


@dataclasses.dataclass
class Program:
    """One canonical program: a trainer, its initial state and batch, and
    the records the passes read (each one tick from ``state``)."""

    name: str
    trainer: Any
    state: Any
    batch: Any
    batch_fn: Callable[[int], Any]
    #: budget id -> (byte ceiling, human label); referenced by memory
    #: contracts via their ("budget", "<id>") param
    budgets: dict[str, tuple[int, str]] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def tick(self):
        """One tick from the initial state: ``(state, metrics)``."""
        return self.trainer.step(self.state, self.batch)

    @functools.cached_property
    def _observed(self) -> tuple[prng_pass.KeyRecord, fence_pass.FenceRecord]:
        """One tick under the key recorder, the fence recorder and the
        apply probe together (none of them changes what the tick computes)."""
        with (prng_pass.recording() as keys, fence_pass.recording() as fences,
              fence_pass.probe_apply(fences)):
            self.tick()
        return keys, fences

    @property
    def key_record(self) -> prng_pass.KeyRecord:
        """The keys one tick drew with and the frames each fed."""
        return self._observed[0]

    @property
    def fence_record(self) -> fence_pass.FenceRecord:
        """The fence sites one tick passed, and the apply's bits."""
        return self._observed[1]

    @functools.cached_property
    def memory_record(self) -> memory_pass.MemoryRecord:
        """One tick's largest new tensor and, on the card, its peak."""
        return memory_pass.measure(self.tick, self.device)[1]


def _const_batch_fn(batch):
    return lambda i: batch


def _line(m: int, n: int, dev) -> torch.Tensor:
    """The reference's batch rows: ``linspace(-1, 1, m n)`` as ``[m, n]``."""
    return torch.linspace(-1.0, 1.0, m * n, dtype=torch.float32, device=dev).reshape(m, n)


def _flat_topology(m: int = 8) -> Topology:
    return erdos_renyi(m, 0.9, 1, seed=1)


def _trainer_program(name, device, topology, *, d, num_byzantine, attack, codec, seed,
                     sparse=False, runtime=None, metrics=None) -> Program:
    dev = resolve_device(device)
    m = topology.num_nodes
    cfg = BridgeConfig(topology=topology, rule="median", num_byzantine=num_byzantine,
                       attack=attack, codec=codec, lam=1.0, t0=10.0, sparse=sparse,
                       metrics=metrics)
    trainer = BridgeTrainer(cfg, quad_grad_fn, runtime=runtime, device=dev)
    params = replicate({"w": torch.zeros(d, device=dev)}, m, perturb=0.1,
                       key=prng.PRNGKey(seed))
    state = trainer.init(params, seed=seed)
    batch = _line(m, d, dev)
    return Program(name, trainer, state, batch, _const_batch_fn(batch))


def build_flat(device="cuda", *, topology: Topology | None = None, d: int = 5,
               num_byzantine: int = 1, seed: int = 0, metrics=None) -> Program:
    return _trainer_program("flat" if metrics is None else "metrics", device,
                            topology or _flat_topology(), d=d, num_byzantine=num_byzantine,
                            attack="random", codec="int8", seed=seed, metrics=metrics)


def build_metrics(device="cuda", **sizes) -> Program:
    from repro_torch.obs.metrics import MetricSpec

    return build_flat(device, metrics=MetricSpec(capacity=8), **sizes)


def build_net(device="cuda", *, topology: Topology | None = None, d: int = 5,
              num_byzantine: int = 1, seed: int = 0) -> Program:
    from repro_torch.net import ChannelConfig, UnreliableRuntime

    topo = topology or _flat_topology()
    rt = UnreliableRuntime(topo, ChannelConfig(drop_prob=0.2), staleness_bound=5,
                           device=resolve_device(device))
    return _trainer_program("net", device, topo, d=d, num_byzantine=num_byzantine,
                            attack="sign_flip", codec="int8", seed=seed, runtime=rt)


def build_sparse(device="cuda", *, topology: Topology | None = None, d: int = 16,
                 num_byzantine: int = 1, seed: int = 0) -> Program:
    topo = topology or erdos_renyi(12, 0.45, 1, seed=3)
    m = topo.num_nodes
    # the budget only means something on a genuinely sparse graph: the
    # screening gather is [M, K+1, d], and K+1 must be < M for "no dense
    # [M, M, d]" to be distinguishable from the gather itself
    kp1 = int(topo.adjacency.sum(axis=1).max()) + 1
    if kp1 >= m:
        raise AssertionError(
            f"canonical sparse graph degenerated: max degree+1 = {kp1} >= "
            f"M = {m}; pick a sparser topology")
    prog = _trainer_program("sparse", device, topo, d=d, num_byzantine=num_byzantine,
                            attack="sign_flip", codec="identity", seed=seed, sparse=True)
    prog.budgets["dense_mmd"] = (m * m * d * _F32, f"dense [M,M,d]=[{m},{m},{d}]")
    return prog


def build_stream(device="cuda", *, topology: Topology | None = None,
                 leaves: dict[str, int] | None = None, screen_chunk: int = 64,
                 num_byzantine: int = 1, seed: int = 0) -> Program:
    from repro_torch.stream.trainer import StreamBridgeTrainer

    dev = resolve_device(device)
    topo = topology or _flat_topology()
    m, leaves = topo.num_nodes, leaves or {"w1": 512, "w2": 256}
    d = sum(leaves.values())
    cfg = BridgeConfig(topology=topo, rule="median", num_byzantine=num_byzantine,
                       attack="sign_flip", codec="int8", lam=1.0, t0=10.0,
                       screen_chunk=screen_chunk)
    trainer = StreamBridgeTrainer(cfg, two_leaf_grad_fn, device=dev)
    params = replicate({k: torch.zeros(n, device=dev) for k, n in leaves.items()}, m,
                       perturb=0.1, key=prng.PRNGKey(seed))
    state = trainer.init(params, seed=seed)
    batch = {k: _line(m, n, dev) for k, n in leaves.items()}
    prog = Program("stream", trainer, state, batch, _const_batch_fn(batch))
    prog.budgets["flat_md"] = (m * d * _F32, f"flat [M,d]=[{m},{d}]")
    return prog


BUILDERS: dict[str, Callable[..., Program]] = {
    "flat": build_flat,
    "sparse": build_sparse,
    "stream": build_stream,
    "net": build_net,
    "metrics": build_metrics,
}

PROGRAM_NAMES = tuple(BUILDERS)


def build(names=PROGRAM_NAMES, device="cuda") -> dict[str, Program]:
    return {n: BUILDERS[n](device) for n in names}


# -- the grid fixture for the set_cells retrace contract --------------------


def build_grid(device="cuda", seed: int = 0):
    """A small two-rule grid plus its init and batches, for the zero-build
    check (`analysis.retrace.check_grid_set_cells`)."""
    from repro_torch.sim.engine import GridEngine
    from repro_torch.sim.grid import ExperimentGrid

    dev = resolve_device(device)
    m, d, ticks = 8, 5, 6
    grid = ExperimentGrid(_flat_topology(m), ("median", "trimmed_mean"), ("sign_flip",),
                          (1,), (seed,), lam=1.0, t0=10.0)
    engine = GridEngine(grid, quad_grad_fn, device=dev)

    def state_fn():
        return engine.init(
            lambda seed: replicate({"w": torch.zeros(d, device=dev)}, m, perturb=0.1,
                                   key=prng.PRNGKey(seed)))

    batch = _line(m, d, dev)
    batches = stack_batches(lambda i: batch, ticks, device=dev)
    return engine, state_fn, batches
