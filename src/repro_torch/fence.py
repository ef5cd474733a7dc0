"""The fence: the port's counterpart of the reference's
`repro.core.screening.fence`, a value rounded to float32 before its
consumer, at a named site.

The reference fences a value behind a length-2 ``lax.scan`` so XLA cannot
contract it into the consumer (the apply's ``rho * g`` before ``y - ...``,
the median's ``0.5 * (lo + hi)``, the metrics' gradient).  PyTorch runs
eagerly and materializes every op's output at its dtype, so `fence`
returns ``x`` in float32 (``x`` itself when it already is).

Site use: `RECORDER` is None unless `repro_torch.analysis.fence` records a
run; a fence then pays one ``is None`` test, and a recorder sees each
site passed, in order.
"""
from __future__ import annotations

import torch

# The fence recorder (`repro_torch.analysis.fence.FenceRecord`); None when
# no check records.
RECORDER = None


def fence(x: torch.Tensor, site: str) -> torch.Tensor:
    """``x`` materialized in float32, at the fence site ``site`` (counted
    while a recorder records)."""
    if RECORDER is not None:
        RECORDER.sites.append(site)
    return x.to(torch.float32)
