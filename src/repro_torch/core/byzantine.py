"""Byzantine attacks (Definition 1) — port of the broadcast, the message
and the wire tiers of `repro.core.byzantine`: ``none``, ``random``,
``sign_flip``, ``same_value``, ``alie``, ``shift``; the per-link
``MessageAttack`` lift of each and ``selective_victim``;
``garbage_codeword``, ``scale_abuse``, ``index_lie``; and
``pick_byzantine_mask``.

An attack substitutes the broadcast rows of ``w [M, d]`` for the nodes in
``byz_mask [M]``; the Byzantine node's own state keeps evolving normally.
Every attack has the signature ``fn(w, byz_mask, key, t)``, ``key`` being
the tick's subkey (`repro_torch.prng`, two uint32 words).

``random`` draws ``10 * normal(fold_in(key, t), [M, d])`` on ``w``'s
device, the reference's draw (`repro_torch.prng.normal`); `random_body`
takes the noise tensor itself.

The broadcast attacks also take the grids' experiment axis: ``w
[E, M, d]``, per-cell masks ``byz_mask [E, M]`` and per-cell keys (``[E,
2]`` row keys, host or device, `repro_torch.prng`), each cell as its own
call computes it: ``random`` draws row e under key e, and ``alie`` and
``shift`` take their honest statistics per cell.

A message attack (`MessageAttack`, the network runtime's tier) crafts the
per-link tensor ``msgs[receiver, sender]``, ``[M, M, d]`` on the dense
layout or ``[M, K, d]`` through a `NeighborTable`, the latter the exact
gather of the former.  A lifted broadcast attack sends every receiver its
broadcast row; ``selective_victim`` lies only to low in-degree receivers.
The message tier takes the grids' experiment axis too (``w [E, M, d]``,
``byz_mask [E, M]``, a live mask every cell shares or one a cell, ``[E, M,
M]`` or ``[E, M, K]``, and the cells' row keys): each cell's messages are
its own call's, ``selective_victim``'s in-degrees counted on the cell's
own live edges.  `apply_message_attack_bank` and its sparse and self-view
twins pick the attack per cell from a static bank, as the reference's do.

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
    return torch.where(byz_mask[..., None], scale * noise, w)


def _random_gaussian(w, byz_mask, key, t):
    return random_body(w, byz_mask, prng.normal(prng.fold_in(key, t), w.shape, w.device))


def _sign_flip(w, byz_mask, key, t, scale: float = 4.0):
    """Broadcast the negated (scaled) true iterate."""
    return torch.where(byz_mask[..., None], -scale * w, w)


def _same_value(w, byz_mask, key, t, value: float = 100.0):
    """All Byzantine nodes collude on one large constant vector."""
    return torch.where(byz_mask[..., None], torch.full_like(w, value), w)


def node_sum(x: torch.Tensor) -> torch.Tensor:
    """``x [.., M, c]`` summed over the node axis, ``[.., c]``: from 0, one
    row after another, in ``x``'s dtype.  Every column takes the same
    additions in the same order at any width ``c``, so an attack on a block
    of columns is that block of the attack on the whole row
    (`repro_torch.stream`); it is also XLA's order at the reference's test
    sizes.  `torch.sum`'s order follows the width.  On CUDA the
    outer-dimension scan of `torch.cumsum` adds the rows in this order in one
    launch (a tensor that is one column and nothing else goes to a parallel
    scan instead); on the CPU cumsum accumulates in double, so a loop."""
    if x.is_cuda and x.numel() > x.shape[-2]:
        return torch.cumsum(x, dim=-2)[..., -1, :]
    acc = torch.zeros_like(x[..., 0, :])
    for i in range(x.shape[-2]):
        acc = acc + x[..., i, :]
    return acc


def _honest_mean(w, honest):
    """The honest rows' mean ``[.., d]`` of ``w [.., M, d]`` and their count
    ``[.., 1]``, per cell."""
    cnt = torch.sum(honest, dim=-1, keepdim=True).to(w.dtype)
    return node_sum(torch.where(honest[..., None], w, 0.0)) / cnt, cnt


def _honest_var(w, honest, mu, cnt):
    """The honest rows' variance ``[.., d]`` about their mean ``mu``."""
    return node_sum(torch.where(honest[..., None], (w - mu[..., None, :]) ** 2, 0.0)) / cnt


def _alie(w, byz_mask, key, t, z: float = 1.5):
    """'A Little Is Enough': collude on mean + z*std of the honest iterates."""
    honest = ~byz_mask
    mu, cnt = _honest_mean(w, honest)
    var = _honest_var(w, honest, mu, cnt)
    crafted = mu + z * torch.sqrt(var + 1e-12)
    return torch.where(byz_mask[..., None], crafted[..., None, :], w)


def _shift(w, byz_mask, key, t, delta: float = 5.0):
    """Coordinated constant shift of the honest mean."""
    mu, _ = _honest_mean(w, ~byz_mask)
    return torch.where(byz_mask[..., None], (mu + delta)[..., None, :], w)


ATTACKS: dict[str, Attack] = {
    "none": Attack("none", _none),
    "random": Attack("random", _random_gaussian),
    "sign_flip": Attack("sign_flip", _sign_flip),
    "same_value": Attack("same_value", _same_value),
    "alie": Attack("alie", _alie),
    "shift": Attack("shift", _shift),
}


@dataclasses.dataclass(frozen=True)
class MessageAttack:
    """An attack on the per-link message tensor.

    ``fn(w, byz_mask, adjacency [M, M], key, t) -> msgs [M, M, d]``,
    ``msgs[j, i]`` what node i sends node j this tick; ``sparse_fn(w,
    byz_mask, nbr, live [M, K], key, t) -> [M, K, d]``, slot (j, k) what
    sender ``nbr.idx[j, k]`` tells j, bit for bit the dense tensor's entry.
    ``broadcast`` is the lifted broadcast attack, if any: Byzantine nodes
    then screen with their attacked broadcast value."""

    name: str
    fn: Callable
    broadcast: Attack | None = None
    sparse_fn: Callable | None = None

    def __call__(self, w, byz_mask, adjacency, key, t):
        return self.fn(w, byz_mask, adjacency, key, t)


def lift_broadcast_attack(attack: Attack) -> MessageAttack:
    """Every receiver gets the sender's (possibly corrupted) broadcast row:
    the broadcast expanded over the receivers (stride 0, nothing copied),
    or gathered through the table."""

    def fn(w, byz_mask, adjacency, key, t):
        w_bcast = attack(w, byz_mask, key, t)
        m = w.shape[-2]
        return w_bcast[..., None, :, :].expand(*w.shape[:-2], m, m, w.shape[-1])

    def sparse_fn(w, byz_mask, nbr, live, key, t):
        return nbr.gather_rows(attack(w, byz_mask, key, t), lead=w.ndim - 2)

    return MessageAttack(attack.name, fn, broadcast=attack, sparse_fn=sparse_fn)


def _median_of_counts(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of an integer vector ``[..., M]`` (one a cell): the
    mean of the two middle values for an even count (``torch.median``
    would return the lower); ``[..., 1]``."""
    s = torch.sort(x.to(torch.float32), dim=-1).values
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2:(n - 1) // 2 + 1] + s[..., n // 2:n // 2 + 1])


def _selective_victim(z: float = 1.5):
    """Byzantine nodes send their true iterate to receivers whose in-degree
    is above the network median, and an ALIE-style crafted value (honest
    mean + z * per-coordinate std) to the others; the victims follow the
    tick's adjacency."""

    def crafted_and_victims(w, byz_mask, in_deg):
        """The crafted row ``[..., 1, 1, d]`` and the victims ``[..., M]``
        of each cell (``w [..., M, d]``, ``in_deg [..., M]``)."""
        honest = ~byz_mask
        mu, cnt = _honest_mean(w, honest)
        var = _honest_var(w, honest, mu, cnt)
        crafted = mu + z * torch.sqrt(var + 1e-12)
        return crafted[..., None, None, :], in_deg <= _median_of_counts(in_deg)

    def fn(w, byz_mask, adjacency, key, t):
        crafted, victim = crafted_and_victims(w, byz_mask, adjacency.sum(dim=-1))
        lie_edge = victim[..., :, None] & byz_mask[..., None, :]  # [receiver, sender]
        return torch.where(lie_edge[..., None], crafted, w[..., None, :, :])

    def sparse_fn(w, byz_mask, nbr, live, key, t):
        # in-degrees from the live slots are the dense row sums exactly
        crafted, victim = crafted_and_victims(w, byz_mask, live.sum(dim=-1))
        lie_edge = victim[..., :, None] & nbr.gather_senders(byz_mask, fill=False)
        return torch.where(lie_edge[..., None], crafted, nbr.gather_rows(w, lead=w.ndim - 2))

    return fn, sparse_fn


MESSAGE_ATTACKS: dict[str, MessageAttack] = {
    name: lift_broadcast_attack(a) for name, a in ATTACKS.items()
}
_sv_fn, _sv_sparse = _selective_victim()
MESSAGE_ATTACKS["selective_victim"] = MessageAttack("selective_victim", _sv_fn,
                                                    sparse_fn=_sv_sparse)


def apply_message_attack(attack: MessageAttack, w, byz_mask, adjacency, key, t):
    """The dense per-link messages (the reference's single-entry
    ``apply_message_attack_bank``)."""
    return attack(w, byz_mask, adjacency, key, t)


def apply_sparse_message_attack(attack: MessageAttack, w, byz_mask, nbr, live, key, t):
    """The ``[M, K, d]`` messages through the table (the single-entry
    ``apply_sparse_message_attack_bank``)."""
    if attack.sparse_fn is None:
        raise ValueError(f"message attack {attack.name!r} has no sparse_fn: required on the "
                         f"neighbor-indexed runtime path")
    return attack.sparse_fn(w, byz_mask, nbr, live, key, t)


def apply_self_view(attack: MessageAttack, w, byz_mask, key, t):
    """The value each node screens with (the single-entry
    ``apply_self_view_bank``): the lifted broadcast, else the iterate."""
    if attack.broadcast is not None:
        return attack.broadcast(w, byz_mask, key, t)
    return w


def messages_and_self(attack: MessageAttack, w, byz_mask, adj_t, key, t, nbr=None):
    """``(msgs, w_self)`` of the tick: `apply_message_attack` (or its
    sparse form, with ``nbr``) and `apply_self_view`.  A lifted attack's
    broadcast is drawn once, as the self-view, and its messages are the
    lifted ``none`` of those rows (the reference draws it twice from one
    key, which gives the same values)."""
    w_self = apply_self_view(attack, w, byz_mask, key, t)
    if attack.broadcast is not None:
        attack, w = MESSAGE_ATTACKS["none"], w_self
    if nbr is not None:
        return apply_sparse_message_attack(attack, w, byz_mask, nbr, adj_t, key, t), w_self
    return apply_message_attack(attack, w, byz_mask, adj_t, key, t), w_self


def _cell_key(keys: np.ndarray):
    """One cell's host key (``[2]``: the trainer's draw) or the cells' host
    row keys ``[E, 2]`` (row e drawn under key e)."""
    return keys[0] if keys.shape[0] == 1 else keys


def _per_attack(bank, attack_idx, w, byz_mask, adjacency, keys, run):
    """``run(attack, w, byz_mask, adjacency, key)`` once per bank entry over
    the cells ``[E, ...]`` that chose it, the outputs scattered back (one
    attack for all: a single call, its outputs kept as they come, a
    receiver stride of 0 included)."""
    idx = np.asarray(attack_idx, np.int64).reshape(-1)
    used = sorted(set(idx.tolist()))
    if len(used) == 1:
        return run(bank[used[0]], w, byz_mask, adjacency, _cell_key(keys))
    outs = None
    for a in used:
        cells = np.nonzero(idx == a)[0]
        sel = torch.as_tensor(cells, device=w.device)
        adj = (adjacency.index_select(0, sel) if adjacency is not None and adjacency.ndim == 3
               else adjacency)
        got = run(bank[a], w.index_select(0, sel), byz_mask.index_select(0, sel), adj,
                  _cell_key(keys[cells]))
        if outs is None:
            outs = tuple(torch.empty((w.shape[0], *g.shape[1:]), dtype=g.dtype,
                                     device=g.device) for g in got)
        for out, g in zip(outs, got, strict=True):
            out.index_copy_(0, sel, g)
    return outs


def apply_message_attack_bank(bank, attack_idx, w, byz_mask, adjacency, keys, t):
    """Each cell's dense per-link messages ``[E, M, M, d]`` from its entry
    of the static ``bank`` (``attack_idx [E]``, host indices): ``w [E, M,
    d]``, ``byz_mask [E, M]``, ``adjacency`` ``[M, M]`` or ``[E, M, M]``,
    ``keys`` the cells' host row keys ``[E, 2]``."""
    return _per_attack(bank, attack_idx, w, byz_mask, adjacency, keys,
                       lambda a, w_, bm, adj, k: (apply_message_attack(a, w_, bm, adj, k, t),))[0]


def apply_sparse_message_attack_bank(bank, attack_idx, w, byz_mask, nbr, live, keys, t):
    """The ``[E, M, K, d]`` twin of `apply_message_attack_bank` through the
    table (``live`` ``[M, K]`` or ``[E, M, K]``)."""
    return _per_attack(bank, attack_idx, w, byz_mask, live, keys,
                       lambda a, w_, bm, lv, k: (apply_sparse_message_attack(
                           a, w_, bm, nbr, lv, k, t),))[0]


def apply_self_view_bank(bank, attack_idx, w, byz_mask, keys, t):
    """Each cell's self-view ``[E, M, d]`` (`apply_self_view` of its bank
    entry)."""
    return _per_attack(bank, attack_idx, w, byz_mask, None, keys,
                       lambda a, w_, bm, _, k: (apply_self_view(a, w_, bm, k, t),))[0]


def messages_and_self_bank(bank, attack_idx, w, byz_mask, adj_t, keys, t, nbr=None):
    """`messages_and_self` of each cell's bank entry over stacked cells:
    ``(msgs [E, M, W, d], w_self [E, M, d])``, each cell's pair bit for
    bit its own call's (`apply_message_attack_bank`,
    `apply_sparse_message_attack_bank` and `apply_self_view_bank`)."""
    return _per_attack(bank, attack_idx, w, byz_mask, adj_t, keys,
                       lambda a, w_, bm, adj, k: messages_and_self(a, w_, bm, adj, k, t, nbr))


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
    keys = prng.split(prng.fold_in(key, t))  # host key or [E, 2] row keys (one a link)
    kp, ki = keys[..., 0, :], keys[..., 1, :]
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


def wire_attack_bank(names) -> tuple[WireAttack, ...]:
    """The codeword component of each attack name (`wire_attack_for`),
    indexed by the same ``attack_idx`` as the iterate banks."""
    return tuple(wire_attack_for(n) for n in names)


def apply_wire_attack_bank(bank, attack_idx, msg, byz, key, t, d: int):
    """Each unit's codeword attacked by its entry of ``bank``: the units
    are ``msg``'s leading axis (a cell's ``[M, ...]`` codewords, or one
    link's), ``attack_idx`` one host index a unit (None: entry 0), ``byz``
    the senders' Byzantine mask over the codewords' leading axes and
    ``key`` one key, host row keys or device row keys ``[U, 2]``.  Each
    attack runs once over the units that chose it."""
    idx = (np.zeros((msg.payload.shape[0],), np.int64) if attack_idx is None
           else np.asarray(attack_idx, np.int64).reshape(-1))
    used = sorted(set(idx.tolist()))
    if len(used) == 1:
        return bank[used[0]](msg, byz, key, t, d)
    out = type(msg)(*(f.clone() for f in msg))
    for a in used:
        if bank[a].name == "none":
            continue
        cells = np.nonzero(idx == a)[0]
        sel = torch.as_tensor(cells, device=msg.payload.device)
        k = (key.index_select(0, sel) if isinstance(key, torch.Tensor)
             else key[cells] if np.ndim(key) == 2 else key)
        got = bank[a](type(msg)(*(f.index_select(0, sel) for f in msg)), byz.index_select(0, sel),
                      k, t, d)
        for o, g in zip(out, got, strict=True):
            o.index_copy_(0, sel, g)
    return out


def attack_names() -> list[str]:
    return sorted(set(ATTACKS) | set(MESSAGE_ATTACKS) | set(WIRE_ATTACKS))


def get_attack(name: str) -> Attack:
    """The broadcast component of attack ``name``; a wire attack's is
    ``none`` (the trainer applies it to the codeword)."""
    if name in WIRE_ATTACKS:
        return ATTACKS["none"]
    try:
        return ATTACKS[name]
    except KeyError:
        if name in MESSAGE_ATTACKS:
            raise ValueError(f"attack {name!r} crafts per-link messages and needs the network "
                             f"runtime (repro_torch.net, BridgeTrainer(runtime=...)); "
                             f"broadcast-path options: {sorted(ATTACKS)}") from None
        raise ValueError(f"unknown attack {name!r}; options: {attack_names()}") from None


def get_message_attack(name: str) -> MessageAttack:
    """The message component of attack ``name``; a wire attack's is the
    lifted ``none``."""
    if name in WIRE_ATTACKS:
        return MESSAGE_ATTACKS["none"]
    try:
        return MESSAGE_ATTACKS[name]
    except KeyError:
        raise ValueError(f"unknown attack {name!r}; options: {attack_names()}") from None


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
