"""Contract manifests for the analysis passes — port of
`repro.analysis.contracts`, the same vocabulary and verdict table.

A *contract* is a machine-checkable invariant declared NEXT TO the code it
governs: each governed module exposes a module-level ``CONTRACTS`` tuple, and
the analysis CLI (`python -m repro_torch.analysis`) collects them all, matches each
against the pass that can discharge it, and reports PASS / FAIL / SKIP per
contract per program.  Keeping the declaration in the governed module (not in
the analysis package) means a refactor that breaks an invariant also has the
contract text in the same diff — reviewers see both sides.

This module is deliberately dependency-light (stdlib only, no torch): the
core modules import it at module load, so it must never import them back.
It is the port's own copy: nothing here imports the reference package.
"""
from __future__ import annotations

import dataclasses
import importlib

# The five pass kinds.  ``kind`` routes a contract to the pass that can
# discharge it; a contract whose pass is not selected reports SKIP.
KINDS = ("prng", "fence", "memory", "retrace", "lint")

#: modules that declare CONTRACTS — the collection roots for the CLI.
GOVERNED_MODULES: tuple[str, ...] = (
    "repro_torch.core.bridge",
    "repro_torch.core.screening",
    "repro_torch.sim.engine",
    "repro_torch.stream.engine",
    "repro_torch.kernels.ops",
    "repro_torch.launch.train",
    "repro_torch.adversary.protocols",
)


@dataclasses.dataclass(frozen=True)
class Contract:
    """One statically checkable invariant.

    ``params`` carries the pass-specific payload as a hashable tuple of
    ``(key, value)`` pairs (budgets, fence floors, waiver site lists...),
    so Contract instances can live in frozenset registries without
    dragging tensors along."""

    name: str  # globally unique, dotted: "<module-nick>.<invariant>"
    kind: str  # one of KINDS
    description: str
    params: tuple[tuple[str, object], ...] = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"contract {self.name!r}: unknown kind {self.kind!r} "
                f"(must be one of {KINDS})")

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """One pass's verdict on one contract (possibly per program)."""

    contract: str   # Contract.name
    kind: str       # Contract.kind (pass that produced the verdict)
    status: str     # "PASS" | "FAIL" | "SKIP"
    detail: str = ""
    program: str = ""  # canonical program name, "" for tree-level checks

    @property
    def ok(self) -> bool:
        return self.status != "FAIL"


def collect(modules: tuple[str, ...] = GOVERNED_MODULES) -> list[Contract]:
    """Import every governed module and gather its CONTRACTS declarations.

    Raises on duplicate contract names across modules — each invariant has
    exactly one home (the same exactly-one-tier discipline the adversary
    registry enforces)."""
    out: list[Contract] = []
    seen: dict[str, str] = {}
    for modname in modules:
        mod = importlib.import_module(modname)
        declared = getattr(mod, "CONTRACTS", ())
        for c in declared:
            if not isinstance(c, Contract):
                raise TypeError(
                    f"{modname}.CONTRACTS holds a non-Contract entry: {c!r}")
            if c.name in seen:
                raise ValueError(
                    f"contract {c.name!r} declared in both {seen[c.name]} "
                    f"and {modname}; contracts have exactly one home")
            seen[c.name] = modname
            out.append(c)
    return out


def by_kind(contracts: list[Contract], kind: str) -> list[Contract]:
    return [c for c in contracts if c.kind == kind]


def summarize(results: list[CheckResult]) -> str:
    """Render a verdict table (stable order: kind, contract, program)."""
    rows = sorted(results, key=lambda r: (KINDS.index(r.kind), r.contract, r.program))
    lines = []
    npass = sum(r.status == "PASS" for r in rows)
    nfail = sum(r.status == "FAIL" for r in rows)
    nskip = sum(r.status == "SKIP" for r in rows)
    for r in rows:
        where = f" [{r.program}]" if r.program else ""
        detail = f" — {r.detail}" if r.detail else ""
        lines.append(f"{r.status:4s} {r.kind:7s} {r.contract}{where}{detail}")
    lines.append(f"{npass} passed, {nfail} failed, {nskip} skipped")
    return "\n".join(lines)
