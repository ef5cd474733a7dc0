"""The stateful adversary protocol — port of `repro.adversary.protocols`.

Every attack of `repro_torch.core.byzantine` is oblivious: a function of
the tick's broadcast alone.  An `Adversary` may also carry observations of
the honest trajectory across ticks (`AdvState`: EMAs of the honest
broadcasts' mean and variance, a tracked direction, a tick count) and see
more than the broadcast through `AdvCtx`: the cell's own screen as a
differentiable closure (``inner_max`` ascends through it), the coordinates
a bandwidth-capped channel will deliver this tick and the channel's
expected latency.

Everything here runs over stacked cells, as the grids hold them:
``w [E, M, d]``, ``byz_mask [E, M]``, a state of ``[E, d]`` rows
(``count [E]``), ``theta`` the cells' hyperparameters as a float32 host
array ``[E, THETA_DIM]`` and ``key`` one host key (E = 1) or the cells'
host row keys ``[E, 2]``; cell e of a call is bit for bit its own E = 1
call.  Every static broadcast attack is registered again as a stateless
adversary (`from_attack`), so one grid axis covers both tiers.

Selection is data, as for rules, attacks and codecs: ``adv_idx`` (one host
index a cell) into a static bank.  A bank of one entry, or cells that all
chose one, is a single call; otherwise each adversary runs once over the
cells that chose it and the rows are scattered back.  The honest sums are
the left-to-right row sums of `repro_torch.kernels.ref.sum_rows`, the
order XLA gives the reference's ``jnp.sum`` over the node axis.
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable, Sequence
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.contracts import Contract
from repro_torch.core import byzantine as byz_lib
from repro_torch.kernels import ref

# Per-cell adversary hyperparameter vector width (CellParams.adv_theta).
THETA_DIM = 4

# EMA decay of the tracked honest-broadcast statistics.
EMA = 0.8


class AdvState(NamedTuple):
    """The adversary's carried observations, one row a cell: ``mean`` /
    ``var`` the EMAs of the honest broadcasts' per-coordinate mean and
    variance, ``dir`` the adversary's tracked direction (the consensus
    motion, the principal deviation axis or the warm-started perturbation)
    and ``count`` the observation ticks so far."""

    mean: torch.Tensor  # [E, d] float32
    var: torch.Tensor  # [E, d]
    dir: torch.Tensor  # [E, d]
    count: torch.Tensor  # [E] float32


class AdvCtx(NamedTuple):
    """What the omniscient adversary sees beyond ``w``: ``screen(wb)`` the
    cells' own screen (``[E, M, d] -> [E, M, d]``, differentiable),
    ``deliver_mask`` the ``[d]`` coordinates a capped channel delivers this
    tick (None: all) and ``latency`` the channel's expected delay in
    ticks."""

    screen: Callable | None = None
    deliver_mask: torch.Tensor | None = None
    latency: float = 0.0


def init_state(dim: int, *, lead: tuple[int, ...] = (),
               device: str | torch.device) -> AdvState:
    """All-zeros carried state with leading axes ``lead`` (one row a
    cell), on ``device`` (the caller names it)."""
    z = lambda: torch.zeros((*lead, dim), dtype=torch.float32, device=device)
    return AdvState(z(), z(), z(), torch.zeros(lead, dtype=torch.float32, device=device))


def state_rows(state: AdvState | None, sel: torch.Tensor) -> AdvState | None:
    """Rows ``sel`` of every field (None passes through)."""
    return None if state is None else AdvState(*(x.index_select(0, sel) for x in state))


@functools.lru_cache(maxsize=256)
def _theta_dev(raw: bytes, rows: int, device: torch.device) -> torch.Tensor:
    host = np.frombuffer(raw, np.float32).reshape(rows, THETA_DIM)
    return torch.as_tensor(host.copy(), device=device)


def theta_on(theta: np.ndarray, device) -> torch.Tensor:
    """The cells' host ``theta [E, THETA_DIM]`` as a float32 tensor on
    ``device`` (copied once per distinct array)."""
    theta = np.ascontiguousarray(theta, np.float32).reshape(-1, THETA_DIM)
    return _theta_dev(theta.tobytes(), theta.shape[0], torch.device(device))


_EMA = float(np.float32(EMA))
_EMA_C = float(np.float32(1.0 - EMA))


def ema(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``EMA * old + (1 - EMA) * new`` as XLA compiles it: the first
    multiply fused into the add, ``fma(EMA, old, (1 - EMA) * new)``, one
    rounding."""
    return ref.fma_f32(old, _EMA, _EMA_C * new)


def honest_stats(w: torch.Tensor, byz_mask: torch.Tensor):
    """``(mu [E, d], sigma [E, d], count [E])`` over the honest rows of
    ``w [E, M, d]``."""
    honest = ~byz_mask
    cnt = torch.clamp(honest.sum(dim=-1), min=1).to(torch.float32)[..., None]
    mu = ref.sum_rows(torch.where(honest[..., None], w, 0.0), dim=-2) / cnt
    dev = w - mu[..., None, :]
    var = ref.sum_rows(torch.where(honest[..., None], dev * dev, 0.0), dim=-2) / cnt
    return mu, torch.sqrt(var + 1e-12), cnt[..., 0]


def observe(state: AdvState, w: torch.Tensor, byz_mask: torch.Tensor):
    """Advance the tracked statistics with this tick's broadcasts: returns
    ``(state', mu, sigma, vel)``, ``vel`` the honest mean's motion against
    the tracked one (zero on a cell's first observation)."""
    mu, sigma, _ = honest_stats(w, byz_mask)
    seen = (state.count > 0)[..., None]
    vel = torch.where(seen, mu - state.mean, torch.zeros_like(mu))
    new_mean = torch.where(seen, ema(state.mean, mu), mu)
    s2 = sigma * sigma
    new_var = torch.where(seen, ema(state.var, s2), s2)
    return state._replace(mean=new_mean, var=new_var, count=state.count + 1.0), mu, sigma, vel


@dataclasses.dataclass(frozen=True)
class Adversary:
    """A (possibly stateful) broadcast-substitution adversary.

    ``fn(ctx, state, theta, w, byz_mask, key, t) -> (w_bcast, state')``
    replaces the Byzantine rows; honest rows pass through bitwise.
    ``message_fn(ctx, state, theta, w, byz_mask, adjacency, key, t) ->
    (msgs [E, M, M, d], self_view [E, M, d], state')`` is the per-link form
    the network runtime drives (`lift_message` derives it for broadcast
    adversaries) and ``sparse_message_fn`` (``nbr, live`` in place of the
    adjacency, ``msgs [E, M, K, d]``) its gather through a
    `NeighborTable`.  ``stateful`` declares whether `AdvState` is read;
    ``tier`` places the name in `registry_tiers`; ``accuse_fn(theta,
    digests, byz_mask, key, t)`` forges the digest rows a slanderer gossips
    (only the trust layer reads it).  ``default_theta`` / ``theta_bounds``
    describe the `THETA_DIM` hyperparameter slots."""

    name: str
    fn: Callable
    stateful: bool = False
    tier: str = "adversary"
    accuse_fn: Callable | None = None
    message_fn: Callable | None = None
    sparse_message_fn: Callable | None = None
    default_theta: tuple[float, ...] = (0.0,) * THETA_DIM
    theta_bounds: tuple[tuple[float, float], ...] = ((0.0, 0.0),) * THETA_DIM

    def __post_init__(self):
        if len(self.default_theta) != THETA_DIM or len(self.theta_bounds) != THETA_DIM:
            raise ValueError(f"adversary {self.name!r}: theta spec must have {THETA_DIM} slots")
        if self.tier not in ("adversary", "equivocator", "slanderer"):
            raise ValueError(f"adversary {self.name!r}: unknown tier {self.tier!r}")


def _delivered(ctx: AdvCtx, crafted: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The lie on the coordinates the channel delivers, the true value
    elsewhere."""
    return crafted if ctx.deliver_mask is None else torch.where(ctx.deliver_mask, crafted, w)


def lift_message(adv: Adversary) -> Callable:
    """The per-link form of a broadcast adversary: every receiver gets the
    crafted row (``[E, M, M, d]`` at a receiver stride of 0), confined to
    the delivered coordinates, and the Byzantine self-view is that row."""

    def mfn(ctx, state, theta, w, byz_mask, adjacency, key, t):
        w_bcast, new_state = adv.fn(ctx, state, theta, w, byz_mask, key, t)
        w_bcast = _delivered(ctx, w_bcast, w)
        e, m, d = w.shape
        return w_bcast[:, None].expand(e, m, m, d), w_bcast, new_state

    return mfn


def lift_message_sparse(adv: Adversary) -> Callable:
    """`lift_message` through the table: the crafted rows gathered into each
    receiver's ``[K, d]`` slots."""

    def mfn(ctx, state, theta, w, byz_mask, nbr, live, key, t):
        w_bcast, new_state = adv.fn(ctx, state, theta, w, byz_mask, key, t)
        w_bcast = _delivered(ctx, w_bcast, w)
        return nbr.gather_rows(w_bcast, lead=1), w_bcast, new_state

    return mfn


def from_attack(attack: byz_lib.Attack) -> Adversary:
    """A static broadcast attack as a stateless adversary."""

    def fn(ctx, state, theta, w, byz_mask, key, t):
        return attack(w, byz_mask, key, t), state

    return Adversary(attack.name, fn, stateful=False)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ADVERSARIES: dict[str, Adversary] = {}


def register(adv: Adversary) -> Adversary:
    if adv.name in ADVERSARIES:
        raise ValueError(f"adversary {adv.name!r} already registered")
    ADVERSARIES[adv.name] = adv
    return adv


for _attack in byz_lib.ATTACKS.values():
    register(from_attack(_attack))


def get_adversary(name: str) -> Adversary:
    try:
        return ADVERSARIES[name]
    except KeyError:
        raise ValueError(f"unknown adversary {name!r}; options: {sorted(ADVERSARIES)}") from None


def registry_tiers() -> dict[str, frozenset[str]]:
    """The six tiers of the attack namespace (each name in exactly one):
    ``broadcast``, ``message`` (per-link only), ``wire``, ``adversary``,
    ``equivocator`` and ``slanderer``."""
    adaptive = frozenset(ADVERSARIES) - frozenset(byz_lib.ATTACKS)
    by_tier = {tier: frozenset(n for n in adaptive if ADVERSARIES[n].tier == tier)
               for tier in ("adversary", "equivocator", "slanderer")}
    return {
        "broadcast": frozenset(byz_lib.ATTACKS),
        "message": frozenset(n for n, a in byz_lib.MESSAGE_ATTACKS.items()
                             if a.broadcast is None),
        "wire": frozenset(byz_lib.WIRE_ATTACKS) - {"none"},
        **by_tier,
    }


def attack_names() -> list[str]:
    """Every name of the six tiers, sorted."""
    return sorted(set().union(*registry_tiers().values()))


# ---------------------------------------------------------------------------
# Banks: adversary selection as data
# ---------------------------------------------------------------------------


def adversary_bank(names: Sequence[str]) -> tuple[Adversary, ...]:
    """The static bank of the named adversaries, in order."""
    return tuple(get_adversary(n) for n in names)


def bank_engaged(bank: Sequence[Adversary] | None) -> bool:
    """Whether the bank can alter a broadcast (any entry but ``none``);
    else the step skips the stage."""
    return bank is not None and any(a.name != "none" for a in bank)


def bank_stateful(bank: Sequence[Adversary] | None) -> bool:
    """Whether any entry reads `AdvState` (then the state carries it for
    every cell)."""
    return bank is not None and any(a.stateful for a in bank)


def bank_accuses(bank: Sequence[Adversary] | None) -> bool:
    """Whether any entry forges gossiped digests."""
    return bank is not None and any(a.accuse_fn is not None for a in bank)


def default_thetas(bank: Sequence[Adversary]) -> np.ndarray:
    """``[len(bank), THETA_DIM]`` registered defaults."""
    return np.asarray([a.default_theta for a in bank], np.float32)


def cell_theta(bank: Sequence[Adversary], adv_idx, adv_theta) -> np.ndarray:
    """The cells' hyperparameters ``[E, THETA_DIM]`` (host float32): their
    own ``adv_theta`` when carried, else the chosen entries' defaults."""
    if adv_theta is not None:
        return np.asarray(adv_theta, np.float32).reshape(-1, THETA_DIM)
    return default_thetas(bank)[np.asarray(adv_idx, np.int64).reshape(-1)]


def _groups(adv_idx, e: int):
    idx = (np.zeros((e,), np.int64) if adv_idx is None
           else np.asarray(adv_idx, np.int64).reshape(-1))
    used = sorted(set(idx.tolist()))
    if len(used) == 1:
        return [(used[0], None)]
    return [(a, np.nonzero(idx == a)[0]) for a in used]


def _sub_ctx(ctx: AdvCtx, cells) -> AdvCtx:
    """The context an adversary function sees for the cells ``cells`` of
    the call (host indices, None: all): the bank helpers take
    ``ctx.screen(wb, cells)``, the functions call ``ctx.screen(wb)``."""
    if ctx.screen is None:
        return ctx
    full = ctx.screen
    return ctx._replace(screen=lambda wb: full(wb, cells))


def _key_rows(key, cells):
    return np.asarray(key)[cells] if np.ndim(key) == 2 else key


def _banked(fns, adv_idx, ctx, state, theta, w, byz_mask, key, run, mask=None):
    """``run(fn, ctx, state, theta, w, byz_mask, key, mask) -> (*outputs,
    state')`` once per chosen entry of ``fns`` over its cells (a mask of
    three axes is a cell's own), the outputs and the state scattered
    back."""
    parts = _groups(adv_idx, w.shape[0])
    if parts[0][1] is None:
        return run(fns[parts[0][0]], _sub_ctx(ctx, None), state, theta, w, byz_mask, key, mask)
    outs = None
    new_state = None if state is None else AdvState(*(x.clone() for x in state))
    for a, cells in parts:
        sel = torch.as_tensor(cells, device=w.device)
        mk = mask.index_select(0, sel) if mask is not None and mask.ndim == 3 else mask
        *got, st = run(fns[a], _sub_ctx(ctx, cells), state_rows(state, sel), theta[cells],
                       w.index_select(0, sel), byz_mask.index_select(0, sel),
                       _key_rows(key, cells), mk)
        if outs is None:
            outs = [torch.empty((w.shape[0], *g.shape[1:]), dtype=g.dtype, device=g.device)
                    for g in got]
        for out, g in zip(outs, got, strict=True):
            out.index_copy_(0, sel, g)
        if new_state is not None:
            for out, g in zip(new_state, st, strict=True):
                out.index_copy_(0, sel, g)
    return (*outs, new_state)


def apply_adversary_bank(bank, adv_idx, ctx: AdvCtx, state, theta, w, byz_mask, key, t):
    """The broadcast path: each cell's Byzantine rows replaced by its entry
    of ``bank``; returns ``(w_bcast [E, M, d], state')``.  Here
    ``ctx.screen`` takes ``(wb, cells)``, ``cells`` the host indices of the
    cells ``wb`` holds (None: all of them)."""
    return _banked(bank, adv_idx, ctx, state, theta, w, byz_mask, key,
                   lambda adv, c, st, th, ww, bm, k, _: adv.fn(c, st, th, ww, bm, k, t))


def _message_fns(bank):
    return [a.message_fn if a.message_fn is not None else lift_message(a) for a in bank]


def _sparse_message_fns(bank):
    fns = []
    for a in bank:
        if a.sparse_message_fn is not None:
            fns.append(a.sparse_message_fn)
        elif a.message_fn is None:
            fns.append(lift_message_sparse(a))
        else:
            raise ValueError(f"adversary {a.name!r} crafts per-link messages but has no "
                             f"sparse_message_fn — required on the neighbor-indexed runtime")
    return fns


def apply_message_adversary_bank(bank, adv_idx, ctx: AdvCtx, state, theta, w, byz_mask,
                                 adjacency, key, t):
    """The dense per-link path: ``(msgs [E, M, M, d], self_view [E, M, d],
    state')`` from each cell's entry.  ``adjacency`` is ``[M, M]`` or
    ``[E, M, M]``."""
    return _banked(_message_fns(bank), adv_idx, ctx, state, theta, w, byz_mask, key,
                   lambda fn, c, st, th, ww, bm, k, adj: fn(c, st, th, ww, bm, adj, k, t),
                   adjacency)


def apply_sparse_message_adversary_bank(bank, adv_idx, ctx: AdvCtx, state, theta, w, byz_mask,
                                        nbr, live, key, t):
    """The ``[E, M, K, d]`` per-slot twin through the table ``nbr``
    (``live`` ``[M, K]`` or ``[E, M, K]``)."""
    return _banked(_sparse_message_fns(bank), adv_idx, ctx, state, theta, w, byz_mask, key,
                   lambda fn, c, st, th, ww, bm, k, lv: fn(c, st, th, ww, bm, nbr, lv, k, t),
                   live)


def apply_accuse_bank(bank, adv_idx, theta, digests, byz_mask, key, t):
    """The echo protocol's forging stage: each cell's entry rewrites the
    digest rows its Byzantine nodes gossip (``digests [E, M, M, q]``);
    entries without an ``accuse_fn`` report honestly."""
    ident = lambda th, dg, bm, k, tt: dg
    fns = [a.accuse_fn if a.accuse_fn is not None else ident for a in bank]
    out, _ = _banked(fns, adv_idx, AdvCtx(), None, theta, digests, byz_mask, key,
                     lambda fn, c, st, th, dg, bm, k, _: (fn(th, dg, bm, k, t), st))
    return out


# ---------------------------------------------------------------------------
# Contracts (`python -m repro_torch.analysis`)
# ---------------------------------------------------------------------------

CONTRACTS: tuple[Contract, ...] = (
    Contract(
        "adversary.tiers.partition", "lint",
        "every name in the attack namespace belongs to exactly one of the "
        "six registry tiers (broadcast / message / wire / adversary / "
        "equivocator / slanderer)",
        params=(("check", "adversary_tiers"),),
    ),
)
