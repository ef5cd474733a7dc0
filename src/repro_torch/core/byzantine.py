"""Byzantine attacks (Definition 1) — port of the broadcast and the wire
tiers of `repro.core.byzantine`: ``none``, ``random``, ``sign_flip``,
``same_value``, ``alie``, ``shift``; ``garbage_codeword``, ``scale_abuse``,
``index_lie``; and ``pick_byzantine_mask``.

An attack substitutes the broadcast rows of ``w [M, d]`` for the nodes in
``byz_mask [M]``; the Byzantine node's own state keeps evolving normally.
Every attack has the signature ``fn(w, byz_mask, key, t)``, ``key`` being
the tick's subkey (`repro_torch.prng`, two uint32 words).

``random`` draws ``10 * normal(fold_in(key, t), [M, d])`` on ``w``'s
device, the reference's draw (`repro_torch.prng.normal`); `random_body`
takes the noise tensor itself.

A wire attack (`WireAttack`) corrupts the encoded codeword instead
(`repro_torch.comm.codec.WireMsg`), after honest encoding and before
decoding, on Byzantine senders' rows only; its broadcast component is
``none`` (`get_attack`).  Receivers decode whatever arrives: garbage
float bits under the identity codec include inf and NaN patterns, which
screening's NaN -> +inf guard ranks as outliers.  An attack is a no-op on
fields the codec ignores (scale abuse under the identity codec, index
lies under a dense codec or randk, whose decoder re-derives its indices).
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


@dataclasses.dataclass(frozen=True)
class WireAttack:
    """An attack on the codeword: ``fn(msg, byz, key, t, d) -> WireMsg``,
    ``byz`` the ``[M]`` Byzantine mask, ``key`` the tick's wire key and
    ``d`` the decoded dimension (forged indices stay in ``[0, d)``).
    ``rewrites_scale`` marks an attack on the scale field: the reference's
    decode then no longer sees the encoder's constant zero term
    (`repro_torch.kernels.ref.dequant_carry`)."""

    name: str
    fn: Callable
    rewrites_scale: bool = False

    def __call__(self, msg, byz, key, t, d):
        return self.fn(msg, byz, key, t, d)


def _wire_none(msg, byz, key, t, d):
    return msg


def _sub(field: torch.Tensor, byz: torch.Tensor, crafted: torch.Tensor) -> torch.Tensor:
    """Byzantine senders' rows of one message field replaced by
    ``crafted`` (``byz`` has the message's leading axes)."""
    b = byz.reshape((*byz.shape, *(1,) * (field.ndim - byz.ndim)))
    return torch.where(b, crafted, field)


def _garbage_codeword(msg, byz, key, t, d):
    """Uniform random payload bytes and sparse indices: the decoder sees
    byte soup (under the identity codec, arbitrary float32 patterns)."""
    kp, ki = prng.split(prng.fold_in(key, t))
    dev = msg.payload.device
    payload = prng.randint(kp, msg.payload.shape, -128, 128, torch.int32, dev).to(torch.int8)
    idx = prng.randint(ki, msg.idx.shape, 0, max(d, 1), torch.int32, dev)
    return msg._replace(payload=_sub(msg.payload, byz, payload), idx=_sub(msg.idx, byz, idx))


SCALE_ABUSE_FACTOR = 1e4


def _scale_abuse(msg, byz, key, t, d):
    """An ordinary-looking payload under a dequantization scale inflated
    ``SCALE_ABUSE_FACTOR`` times."""
    return msg._replace(scale=_sub(msg.scale, byz, msg.scale * SCALE_ABUSE_FACTOR))


def _index_lie(msg, byz, key, t, d):
    """Honest-looking values claimed for the first k coordinates."""
    k = msg.idx.shape[-1]
    lie = torch.arange(k, dtype=torch.int32, device=msg.idx.device).expand(msg.idx.shape)
    return msg._replace(idx=_sub(msg.idx, byz, lie))


WIRE_ATTACKS: dict[str, WireAttack] = {
    "none": WireAttack("none", _wire_none),
    "garbage_codeword": WireAttack("garbage_codeword", _garbage_codeword),
    "scale_abuse": WireAttack("scale_abuse", _scale_abuse, rewrites_scale=True),
    "index_lie": WireAttack("index_lie", _index_lie),
}


def wire_attack_for(name: str) -> WireAttack:
    """The codeword component of attack ``name``: its `WireAttack`, or the
    no-op for a broadcast attack (the reference's
    ``wire_attack_bank((name,))[0]``)."""
    return WIRE_ATTACKS.get(name, WIRE_ATTACKS["none"])


def get_attack(name: str) -> Attack:
    """The broadcast component of attack ``name``; a wire attack's is
    ``none`` (the trainer applies it to the codeword)."""
    if name in WIRE_ATTACKS:
        return ATTACKS["none"]
    try:
        return ATTACKS[name]
    except KeyError:
        names = sorted(set(ATTACKS) | set(WIRE_ATTACKS))
        raise ValueError(f"unknown attack {name!r}; options: {names}") from None


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
