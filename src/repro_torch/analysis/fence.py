"""The fences and their pass — the port's counterpart of the fence half of
`repro.analysis.hlo`.

The reference fences a value (`repro.core.screening.fence`) behind a
length-2 ``lax.scan`` so XLA must round it to float32 before its consumer:
the apply's ``rho * g`` before ``y - ...`` (no FNMA contraction), the
median's ``0.5 * (lo + hi)``, the metrics' gradient.  Its pass counts the
trip-2 loops that survive the optimized HLO.

PyTorch runs eagerly: every op's output is materialized at its dtype, so
`repro_torch.fence.fence` returns ``x`` in float32 and already forbids
contraction into the consumer.  What can still break is the code: an
apply rewritten as one fused op (``torch.addcmul``, or a kernel that
contracts ``y - rho * g`` into an FMA) drops the rounding.  So this pass
checks the port's own artifacts:

* each fence call names its site; while a `FenceRecord` is on (`recording`
  sets `repro_torch.fence.RECORDER`) the sites a tick passes are counted;
* ``screening.fence.survives``: every program's tick passes at least
  ``min_fences`` sites, the apply's (`APPLY_SITE`) among them, and the
  apply's result equals ``y - fence(rho * g)`` recomputed from its own
  ``y``, ``rho`` and ``g``, bit for bit (`probe_apply` watches
  `repro_torch.core.bridge.apply_update` from outside);
* ``screening.metrics.gradnorm_unfused``: the metrics program passes
  exactly one site more than the flat one.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch import fence as fence_lib
from repro_torch.analysis.contracts import CheckResult

#: the apply's fence site (``rho * g``)
APPLY_SITE = "bridge.apply"


@dataclasses.dataclass
class FenceRecord:
    """The sites passed while recording, in order, and what the apply
    probe saw: its calls and the elements that differed from ``y -
    fence(rho * g)`` (counted on the device, read once)."""

    sites: list = dataclasses.field(default_factory=list)
    applies: int = 0
    apply_elements: int = 0
    differing: list = dataclasses.field(default_factory=list)
    ticks: int = 1  # the ticks recorded (the counts the checks read are per tick)

    def count(self, site: str | None = None) -> int:
        return len(self.sites) if site is None else self.sites.count(site)

    def per_tick(self, site: str | None = None) -> float:
        return self.count(site) / self.ticks

    @property
    def apply_mismatches(self) -> int:
        return int(torch.stack(self.differing).sum()) if self.differing else 0


@contextlib.contextmanager
def recording():
    """Count the fence sites passed inside the block into a fresh
    `FenceRecord`."""
    if fence_lib.RECORDER is not None:
        raise RuntimeError("a fence recorder is already on")
    rec = fence_lib.RECORDER = FenceRecord()
    try:
        yield rec
    finally:
        fence_lib.RECORDER = None


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: equal bits (NaN payloads included)."""
    return a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32)


@contextlib.contextmanager
def probe_apply(record: FenceRecord):
    """Watch `repro_torch.core.bridge.apply_update` (whatever it is bound
    to) from outside: each call's result is held against ``y - (rho *
    g)`` with the product rounded to float32 first, recomputed from the
    call's own operands, and the differing elements counted into
    ``record``."""
    from repro_torch.core import bridge

    inner = bridge.apply_update

    def probed(y, rho, g):
        out = inner(y, rho, g)
        want = y - (rho * g).to(torch.float32)
        record.applies += 1
        record.apply_elements += out.numel()
        record.differing.append((~_bits_equal(out, want)).sum())
        return out

    bridge.apply_update = probed
    try:
        yield record
    finally:
        bridge.apply_update = inner


def check_fence_floor(contract, program_name: str, record: FenceRecord,
                      min_fences: int = 1) -> CheckResult:
    """Each tick passes >= ``min_fences`` fence sites, the apply's among
    them, and the apply's bits are ``y - fence(rho * g)``'s."""
    n, n_apply = record.per_tick(), record.per_tick(APPLY_SITE)
    problems = []
    if n < min_fences:
        problems.append(f"only {n:g} fence site(s) a tick (declared floor {min_fences})")
    if n_apply == 0:
        problems.append(f"the apply's fence ({APPLY_SITE}) was not passed")
    if record.applies == 0:
        problems.append("the apply was not probed")
    if record.apply_mismatches:
        problems.append(f"{record.apply_mismatches} of {record.apply_elements} apply element(s) "
                        f"differ from y - fence(rho * g)")
    sites = ", ".join(f"{s} x{record.per_tick(s):g}" for s in dict.fromkeys(record.sites))
    return CheckResult(
        contract=contract.name, kind="fence", program=program_name,
        status="PASS" if not problems else "FAIL",
        detail=(f"{n:g} fence site(s) a tick ({sites}); the apply's {record.apply_elements} "
                f"element(s) are y - fence(rho * g) bit for bit"
                if not problems else
                "; ".join(problems) + " — the apply's rounding is no longer fenced"))


def check_metrics_fence_delta(contract, flat: FenceRecord, metrics: FenceRecord,
                              delta: int = 1) -> CheckResult:
    """The metrics program passes exactly ``delta`` more sites a tick than
    the flat one: the gradient norm's fence, and no other site lost."""
    n_flat, n_met = flat.per_tick(), metrics.per_tick()
    ok = n_met == n_flat + delta
    return CheckResult(
        contract=contract.name, kind="fence", program="metrics",
        status="PASS" if ok else "FAIL",
        detail=(f"fence sites a tick: metrics-off {n_flat:g}, metrics-on {n_met:g} (the "
                f"gradient norm reads a fenced gradient)"
                if ok else
                f"fence sites a tick: metrics-off {n_flat:g}, metrics-on {n_met:g}, expected "
                f"+{delta} — "
                f"the gradient norm's fence is missing or a site was lost when metrics engaged"))
