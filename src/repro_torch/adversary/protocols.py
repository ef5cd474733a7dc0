"""The adversary registry — the part of `repro.adversary.protocols` that
the batched grids (`repro_torch.sim.engine`) read: `THETA_DIM`, the
registry with its ``none`` entry, `get_adversary`, `adversary_bank` and
`bank_stateful`.

The reference registers every static broadcast attack again as a
stateless adversary, and its adaptive and protocol-level adversaries
(``ipm``, ``alie_online``, ``inner_max``, equivocators, slanderers) on
top; those, and the adversary stage of the step, are ROADMAP Queue 1
item 12.  Here any name but ``none`` raises.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

# Per-cell adversary hyperparameter vector width (the reference's
# ``CellParams.adv_theta``).
THETA_DIM = 4


@dataclasses.dataclass(frozen=True)
class Adversary:
    """A registered adversary: its name, whether it carries state across
    ticks, and its default hyperparameters (``THETA_DIM`` floats)."""

    name: str
    stateful: bool = False
    default_theta: tuple[float, ...] = (0.0,) * THETA_DIM

    def __post_init__(self):
        if len(self.default_theta) != THETA_DIM:
            raise ValueError(f"adversary {self.name!r}: theta must have {THETA_DIM} slots")


ADVERSARIES: dict[str, Adversary] = {"none": Adversary("none")}


def get_adversary(name: str) -> Adversary:
    """The registered adversary ``name``: ``none`` only, for now."""
    try:
        return ADVERSARIES[name]
    except KeyError:
        raise ValueError(
            f"adversary {name!r} is not in the port yet: the adaptive and protocol-level "
            f"adversaries are ROADMAP Queue 1 item 12; options: {sorted(ADVERSARIES)}") from None


def adversary_bank(names: Sequence[str]) -> tuple[Adversary, ...]:
    """The static bank of the named adversaries, in order."""
    return tuple(get_adversary(n) for n in names)


def bank_stateful(bank: Sequence[Adversary] | None) -> bool:
    """Whether any adversary of the bank carries state (then the grid's
    state carries it for every cell)."""
    return bank is not None and any(a.stateful for a in bank)
