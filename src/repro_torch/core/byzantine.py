"""Byzantine broadcast attacks (Definition 1) — port of the broadcast tier
of `repro.core.byzantine`: ``none``, ``random``, ``sign_flip``,
``same_value``, ``alie``, ``shift`` and ``pick_byzantine_mask``.

An attack substitutes the broadcast rows of ``w [M, d]`` for the nodes in
``byz_mask [M]``; the Byzantine node's own state keeps evolving normally.
Every attack has the signature ``fn(w, byz_mask, key, t)``, ``key`` being
the tick's subkey (`repro_torch.prng`, two uint32 words).

``random`` draws ``10 * normal(fold_in(key, t), [M, d])`` on ``w``'s
device, the reference's draw (`repro_torch.prng.normal`); `random_body`
takes the noise tensor itself.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass(frozen=True)
class Attack:
    name: str
    fn: Callable  # (w [M,d], byz_mask [M], key, t) -> w_broadcast [M,d]

    def __call__(self, w, byz_mask, key, t):
        return self.fn(w, byz_mask, key, t)


def _none(w, byz_mask, key, t):
    return w


RANDOM_SCALE = 10.0


def random_body(w: torch.Tensor, byz_mask: torch.Tensor, noise: torch.Tensor,
                scale: float = RANDOM_SCALE) -> torch.Tensor:
    """The paper's attack given its standard-normal ``noise [M, d]``:
    Byzantine rows broadcast ``scale * noise``."""
    return torch.where(byz_mask[:, None], scale * noise, w)


def _random_gaussian(w, byz_mask, key, t):
    return random_body(w, byz_mask, prng.normal(prng.fold_in(key, t), w.shape, w.device))


def _sign_flip(w, byz_mask, key, t, scale: float = 4.0):
    """Broadcast the negated (scaled) true iterate."""
    return torch.where(byz_mask[:, None], -scale * w, w)


def _same_value(w, byz_mask, key, t, value: float = 100.0):
    """All Byzantine nodes collude on one large constant vector."""
    return torch.where(byz_mask[:, None], torch.full_like(w, value), w)


def _honest_mean(w, honest):
    cnt = torch.sum(honest).to(w.dtype)
    return torch.sum(torch.where(honest[:, None], w, 0.0), dim=0) / cnt, cnt


def _alie(w, byz_mask, key, t, z: float = 1.5):
    """'A Little Is Enough': collude on mean + z*std of the honest iterates."""
    honest = ~byz_mask
    mu, cnt = _honest_mean(w, honest)
    var = torch.sum(torch.where(honest[:, None], (w - mu) ** 2, 0.0), dim=0) / cnt
    crafted = mu + z * torch.sqrt(var + 1e-12)
    return torch.where(byz_mask[:, None], crafted[None, :], w)


def _shift(w, byz_mask, key, t, delta: float = 5.0):
    """Coordinated constant shift of the honest mean."""
    mu, _ = _honest_mean(w, ~byz_mask)
    return torch.where(byz_mask[:, None], (mu + delta)[None, :], w)


ATTACKS: dict[str, Attack] = {
    "none": Attack("none", _none),
    "random": Attack("random", _random_gaussian),
    "sign_flip": Attack("sign_flip", _sign_flip),
    "same_value": Attack("same_value", _same_value),
    "alie": Attack("alie", _alie),
    "shift": Attack("shift", _shift),
}


def get_attack(name: str) -> Attack:
    try:
        return ATTACKS[name]
    except KeyError:
        raise ValueError(f"unknown attack {name!r}; options: {sorted(ATTACKS)}") from None


def pick_byzantine_mask(num_nodes: int, num_byzantine: int, seed: int = 0) -> np.ndarray:
    """Deterministically pick which nodes are Byzantine (the reference's
    draw: same seed, same mask)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(num_nodes, size=num_byzantine, replace=False)
    mask = np.zeros((num_nodes,), dtype=bool)
    mask[idx] = True
    return mask


def byzantine_nodes(num_nodes: int, num_byzantine: int, attack: str, seed: int,
                    device: str | torch.device) -> torch.Tensor:
    """The trainers' ``[M]`` Byzantine mask on ``device``: no node under the
    ``none`` attack or with ``num_byzantine == 0``, else
    `pick_byzantine_mask` of ``min(num_byzantine, num_nodes)`` nodes."""
    nbyz = min(num_byzantine, num_nodes)
    if attack == "none" or nbyz == 0:
        return torch.zeros((num_nodes,), dtype=torch.bool, device=device)
    return torch.as_tensor(pick_byzantine_mask(num_nodes, nbyz, seed), device=device)
