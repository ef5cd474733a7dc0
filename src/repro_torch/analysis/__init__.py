"""repro_torch.analysis — the contract gate of the port; counterpart of
`repro.analysis`, checked on the port's own artifacts (the PyTorch
program runs eagerly, so there is no jaxpr or HLO to read):

* **prng** (`repro_torch.analysis.prng`)     — a recorder of key use at
  run time: no key feeds two distinct draws;
* **fence** (`repro_torch.analysis.fence`)   — the fence sites a tick
  passes, and the apply's bits against ``y - fence(rho * g)``;
* **memory** (`repro_torch.analysis.memory`) — the largest tensor a tick
  creates (a dispatch mode), the card's allocator peak, and the chunked
  runner keeping no earlier tick's carry alive;
* **retrace** (`repro_torch.analysis.retrace`) — the port's build caches
  and the grid engine's built steps stay warm across the promised update
  patterns;
* **lint** (`repro_torch.analysis.lint`)     — registries and source
  tree: partitions, completeness, frozen specs, kernel twins, seed
  plumbing.

Contracts live NEXT TO governed code as module-level ``CONTRACTS`` tuples
(see `repro_torch.analysis.contracts.GOVERNED_MODULES`); the CLI is
``python -m repro_torch.analysis``.

This package's top level re-exports only the dependency-light contract
vocabulary: governed modules import `repro_torch.analysis.contracts` at
module load, so importing programs or the driver here would make a cycle.
The recorders' hooks live in the low-level modules (`repro_torch.prng`,
`repro_torch.fence`); the passes here only switch them on and read them.
"""
from repro_torch.analysis.contracts import (
    GOVERNED_MODULES,
    KINDS,
    CheckResult,
    Contract,
    by_kind,
    collect,
    summarize,
)

__all__ = [
    "GOVERNED_MODULES", "KINDS", "CheckResult", "Contract",
    "by_kind", "collect", "summarize",
]
