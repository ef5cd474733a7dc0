"""Experiment-grid specifications — port of `repro.sim.grid`.

The paper's headline results (Figs. 2-5, Sec. V) are *grids* — screening rule
x attack x Byzantine count x seed (x network scenario).  An `ExperimentGrid`
names the axes; `cells()` expands the cross product into `Cell`s, each a
single experiment identical in meaning to one `BridgeTrainer` /
`AsyncBridgeTrainer` run.  `repro_torch.sim.engine.GridEngine` runs a list
of cells (the full product, or the not-yet-computed subset of a resumable
sweep) over stacked state, every screening kernel launching once a tick for
a group of cells.  `Cell.tag` is the reference's, byte for byte, so a result
store written by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Sequence
from typing import NamedTuple

import numpy as np

from repro_torch.core import byzantine as byz_lib
from repro_torch.core import screening
from repro_torch.core.graph import Topology, erdos_renyi


class Cell(NamedTuple):
    """One experiment: a single point of the grid's cross product, run by
    `repro_torch.sim.engine.GridEngine` as its own trainer would run it.

    ``scenario`` is ``None`` for the synchronous broadcast path, or a
    `repro_torch.net.scenarios` name for the unreliable-network path.
    ``attack`` may be a wire attack (``garbage_codeword``, ``scale_abuse``,
    ``index_lie``), which corrupts the Byzantine senders' codewords.
    ``codec`` names the wire format (`repro_torch.comm.codec`) neighbor
    exchange travels in, per sender or, on a net cell, per link, with its
    carry.  ``adversary`` names a `repro_torch.adversary` entry (``"none"``
    skips the adversary stage), ``theta`` its per-cell hyperparameters
    (`THETA_DIM` floats, the step's ``CellParams.adv_theta``; None takes the
    adversary's defaults), and ``mask_seed`` the draw that picks *which*
    nodes are Byzantine (None falls back to the grid's shared
    ``byzantine_seed``, so every seed draws the same mask).
    """

    rule: str
    attack: str
    b: int
    seed: int
    scenario: str | None = None
    codec: str = "identity"
    adversary: str = "none"
    mask_seed: int | None = None
    theta: tuple | None = None

    @property
    def tag(self) -> str:
        """Stable result-store key (file stem) for this cell.  Identity-codec
        / no-adversary tags match the pre-codec layout, so existing stores
        stay resumable — EXCEPT cells whose Byzantine placement actually
        changed under the mask_seed fix (mask_seed != 0 with a live mask),
        which get a ``_m<seed>`` marker so resumable stores never silently
        mix old-mask and new-mask results under one key."""
        base = f"{self.rule}_{self.attack}_b{self.b}_s{self.seed}"
        if (self.mask_seed not in (None, 0) and self.b > 0
                and not (self.attack == "none" and self.adversary == "none")):
            base = f"{base}_m{self.mask_seed}"
        if self.adversary != "none":
            base = f"{base}_adv_{self.adversary}"
        if self.theta is not None:
            import zlib

            base = f"{base}_th{zlib.crc32(repr(tuple(self.theta)).encode()):08x}"
        if self.scenario:
            base = f"{base}_{self.scenario}"
        return f"{base}_{self.codec}" if self.codec != "identity" else base


@dataclasses.dataclass(frozen=True)
class ExperimentGrid:
    """The cross product rules x attacks x byzantine_counts x seeds
    (x scenarios), over one shared topology and step-size schedule.

    ``scenarios=None`` runs the synchronous broadcast simulation; otherwise
    every cell runs through the unreliable-network runtime (the two paths
    carry different state and cannot mix inside one batch — split them into
    two grids).
    """

    topology: Topology
    rules: Sequence[str]
    attacks: Sequence[str]
    byzantine_counts: Sequence[int] = (1,)
    seeds: Sequence[int] = (0,)
    scenarios: Sequence[str] | None = None
    codecs: Sequence[str] = ("identity",)
    adversaries: Sequence[str] = ("none",)
    lam: float = 1.0
    t0: float = 50.0
    lr: float = 0.0
    byzantine_seed: int = 0
    # seed-axis sweeps vary WHICH nodes are Byzantine (mask_seed =
    # byzantine_seed + seed), not just data/init.  False restores the legacy
    # behavior where one shared mask made every "seed" replicate the same
    # Byzantine placement.
    mask_from_seed: bool = True

    def __post_init__(self):
        for axis in ("rules", "attacks", "byzantine_counts", "seeds", "scenarios",
                     "codecs", "adversaries"):
            vals = getattr(self, axis)
            if vals is not None and len(vals) != len(set(vals)):
                raise ValueError(f"duplicate entries on grid axis {axis}: {vals}")
        for rule in self.rules:
            screening.min_neighbors(rule, 0)  # raises for an unknown rule
        for attack in self.attacks:
            if self.scenarios is None:
                byz_lib.get_attack(attack)  # raises for message-only attacks
            else:
                byz_lib.get_message_attack(attack)
        from repro_torch.adversary import get_adversary
        from repro_torch.comm.codec import get_codec

        for adv in self.adversaries:
            get_adversary(adv)
        for codec in self.codecs:
            get_codec(codec)
        if self.scenarios is not None:
            from repro_torch.net.scenarios import get_scenario

            for s in self.scenarios:
                get_scenario(s)
        for rule in self.rules:
            for b in self.byzantine_counts:
                need = screening.min_neighbors(rule, b)
                if self.topology.min_in_degree < need:
                    raise ValueError(
                        f"rule {rule!r} with b={b} needs min in-degree >= {need}, "
                        f"grid topology has {self.topology.min_in_degree}"
                    )

    @property
    def num_cells(self) -> int:
        s = len(self.scenarios) if self.scenarios else 1
        return (len(self.rules) * len(self.attacks) * len(self.byzantine_counts)
                * len(self.seeds) * s * len(self.codecs) * len(self.adversaries))

    def cells(self) -> list[Cell]:
        """Rule-major expansion of the cross product."""
        scen = self.scenarios if self.scenarios is not None else (None,)
        return [
            Cell(r, a, b, s, sc, cd, adv,
                 mask_seed=(self.byzantine_seed + s) if self.mask_from_seed else None)
            for r, a, b, s, sc, cd, adv in itertools.product(
                self.rules, self.attacks, self.byzantine_counts, self.seeds, scen,
                self.codecs, self.adversaries,
            )
        ]


def default_topology(num_nodes: int, rules: Sequence[str], byzantine_counts: Sequence[int],
                     *, seed: int = 0) -> Topology:
    """An ER topology dense enough for every (rule, b) cell of a grid —
    escalating edge probability until Table-II minimum degrees hold (p = 1.0
    is the complete graph, which satisfies every rule at paper scale)."""
    b_max = max(byzantine_counts)
    need = max(screening.min_neighbors(r, b) for r in rules for b in byzantine_counts)
    for p in (0.5, 0.6, 0.7, 0.8, 0.9, 1.0):
        try:
            topo = erdos_renyi(num_nodes, p, b_max, seed=seed)
        except RuntimeError:
            continue
        if topo.min_in_degree >= need:
            return topo
    raise RuntimeError(
        f"no ER({num_nodes}) topology supports rules={list(rules)} with b up to {b_max} "
        f"(need min in-degree >= {need}; use more nodes)"
    )


def pick_byz_mask(num_nodes: int, cell: Cell, byzantine_seed: int = 0) -> np.ndarray:
    """The cell's attacking-node mask — exactly `BridgeTrainer.__init__`'s
    rule: no attackers when neither an attack nor an adversary is named or
    b == 0, else a seeded draw of b nodes.  The draw uses the cell's own
    ``mask_seed`` when set (seed-axis sweeps then vary *which* nodes attack),
    falling back to the grid-shared ``byzantine_seed``."""
    if (cell.attack == "none" and cell.adversary == "none") or cell.b == 0:
        return np.zeros((num_nodes,), dtype=bool)
    nbyz = min(cell.b, num_nodes)
    seed = cell.mask_seed if cell.mask_seed is not None else byzantine_seed
    return np.asarray(byz_lib.pick_byzantine_mask(num_nodes, nbyz, seed))
