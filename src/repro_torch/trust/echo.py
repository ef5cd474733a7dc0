"""The commit-then-gossip echo protocol: equivocation detection (port of
`repro.trust.echo`).

An equivocator sends different payloads to different receivers; each
receiver alone sees a plausible message.  The protocol cross-checks:

1. **commit** — each receiver digests what it holds from each in-neighbor
   by a random projection ``h = payload @ R_t``, ``R_t [d, q]`` a public
   Gaussian drawn from the tick's trust key (`digest_matrix`);
2. **gossip** — neighbors exchange their digest rows over the tick's live
   links;
3. **cross-check** — receivers j and l compare their digests of a common
   sender i only when both mailbox entries come from the same send tick
   (`repro_torch.net.mailbox.generation_match`), so drops and latency are
   excluded, never counted;
4. **quorum** — an edge (j <- i) earns evidence 1 only when at least b + 1
   witnesses disagree with j's digest: at most b Byzantine witnesses
   exist, so slanderers (whose forged rows `protocols.apply_accuse_bank`
   writes) can never frame an honest sender.

The cross-check runs in the dense ``[M, M]`` sender space on both layouts
(`scatter_dense` lifts a table's ``[M, K]`` slots), O(M^2 q + M^3), fine at
the study scales the trust layer targets.  The port digests a table's
``[M, K]`` views before lifting them (the reference lifts the views, then
digests): each digest is its own row's product, and only entries both
sides hold are compared.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng


def digest_matrix(key, dim: int, digest_dim: int, device) -> torch.Tensor:
    """The tick's public projection ``R_t [d, q]``, ``normal(key)``: every
    node uses the same matrix, so identical payloads digest to identical
    floats."""
    return prng.normal(key, (dim, digest_dim), device)


def digest_all(spec, values: torch.Tensor, key) -> torch.Tensor:
    """``[.., n, d] -> [.., n, q]`` digests of the mailbox contents, the
    product ``torch.matmul`` (a plain product in the reference too).
    ``key`` is one host key, or the cells' host keys ``[E, 2]`` against
    values ``[E, ..]``, each cell under its own matrix."""
    key = np.asarray(key, np.uint32)
    d = values.shape[-1]
    if key.ndim == 1:
        return values @ digest_matrix(key, d, spec.digest_dim, values.device)
    mats = torch.stack([digest_matrix(k, d, spec.digest_dim, values.device) for k in key])
    lead = values.shape[1:-1]
    flat = values.reshape(values.shape[0], -1, d)
    return torch.bmm(flat, mats).reshape(values.shape[0], *lead, spec.digest_dim)


def scatter_dense(neighbors, x: torch.Tensor, fill, *, tail: int = 0) -> torch.Tensor:
    """``[.., M, K, *tail] -> [.., M, M, *tail]`` (``tail`` trailing dims
    after the slot axes): slot (j, k) lands at column ``idx[j, k]``; padded
    slots are dropped, so they never overwrite a real sender's entry."""
    m, k = neighbors.safe_idx.shape
    pre = x.shape[:x.ndim - 2 - tail]
    rest = x.shape[x.ndim - tail:]
    col = torch.where(neighbors.valid_dev.bool(), neighbors.safe_idx.long(), m)  # m: dropped
    out = torch.full((*pre, m, m + 1, *rest), fill, dtype=x.dtype, device=x.device)
    idx = col.reshape(*([1] * len(pre)), m, k, *([1] * tail)).expand(x.shape)
    out.scatter_(len(pre) + 1, idx, x)
    return out.narrow(len(pre) + 1, 0, m)


def equivocation_evidence(digests: torch.Tensor, gens: torch.Tensor, valid: torch.Tensor,
                          gossip: torch.Tensor, b, *, tol: float
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The quorum cross-check in the dense sender space, one cell or E
    (leading ``[E]`` on every operand).

    ``digests [.., M, M, q]``: row j is j's reported digests of what it
    received from each sender (slanderers' rows already forged);
    ``gens [.., M, M]`` the mailbox send ticks, ``valid [.., M, M]`` the
    usable entries, ``gossip [.., M, M]`` the tick's live links
    (``gossip[j, l]``: j hears l's digest row), ``b`` the cell's bound (an
    int, or ``[E]``), ``tol`` the relative digest tolerance.  Returns
    ``(evidence [.., M, M] float32 in {0, 1}, mismatches [.., M, M]
    float32 witness counts)``."""
    from repro_torch.net import mailbox as mb  # the net package imports the trainer

    # comparable (j, l, i): j and l both hold a usable entry from i of the
    # same send tick, and l's row reached j this tick
    both = (valid[..., :, None, :] & valid[..., None, :, :]
            & mb.generation_match(gens[..., :, None, :], gens[..., None, :, :]))
    cmp = gossip.bool()[..., :, :, None] & both
    dj = digests[..., :, None, :, :]
    dl = digests[..., None, :, :, :]
    scale = 1.0 + torch.maximum(torch.abs(dj), torch.abs(dl))
    differs = torch.any(torch.abs(dj - dl) > tol * scale, dim=-1)
    mism = torch.sum(torch.where(cmp & differs, 1.0, 0.0), dim=-2)
    bb = torch.as_tensor(b, dtype=torch.int32, device=mism.device)
    if bb.ndim:
        bb = bb.reshape(-1, 1, 1)
    evidence = (mism >= (bb + 1)).to(torch.float32)
    return evidence, mism
