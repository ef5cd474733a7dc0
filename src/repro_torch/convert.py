"""Weights across from the JAX package, as numpy arrays, or through the
reference's checkpoint files.

The port reads and writes the reference's checkpoint layout itself
(`repro_torch.checkpoint`, no ``msgpack`` needed): `state_from_checkpoint`
resumes a reference `BridgeState` on the plain path (identity codec, no
network, adversary, trace, trust or metrics carry), whose leaves the two
packages share; the other carries cross files only within the port (their
layouts differ between the packages).  A nested parameter tree (the model
zoo's) crosses as the port's flat dict (`flatten_tree`, `params_from_jax`)
and back (`params_to_jax`).  Otherwise a caller hands over the state as
numpy arrays: each leaf of the reference's
``state.params``, its ``state.key`` and, for a lossy codec, its
``state.comm`` carry, for a stateful adversary its ``state.adv``, for a
traced run its ``state.obs`` (the forensic fields included), for a run
with the trust layer its ``state.trust``, for a run with a metrics spec its
ring ``state.mets``; for the batched grids the stacked state of the
reference's ``GridEngine`` (`grid_state_from_jax`, a net grid's stacked
mailboxes, the codec carries, the adversary's state, the trace's
aggregates, the trust states and the metric rings included); for the
chunk-streaming trainer the reference's ``StreamBridgeTrainer`` state
(`stream_state_from_jax`: the per-leaf codec carries and the per-block
mailboxes).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch import prng
from repro_torch.adversary.protocols import AdvState
from repro_torch.comm.exchange import CommState
from repro_torch.core.brdso import BrdsoState
from repro_torch.core.bridge import BridgeState
from repro_torch.net.mailbox import BlockMailboxState, MailboxState
from repro_torch.core.byrdie import ByrdieState
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import MetricState
from repro_torch.obs.trace import TraceState
from repro_torch.trust.reputation import TrustState


SEP = "/"  # joins a nested tree's path keys into the port's flat keys


def flatten_tree(tree: Mapping) -> dict:
    """A nested parameter tree (dicts of dicts, array leaves) as the port's
    flat dict: each leaf under its path's keys joined by ``/``
    (``{"blocks": {"attn": {"wq": a}}}`` -> ``{"blocks/attn/wq": a}``).
    The zoo's keys hold letters, digits and ``_``, all above ``/``, so
    sorting the flat keys gives the nested tree's leaf order.  A ``None``
    value (a pytree with no leaves: the MoE family's ``dense_blocks``
    without dense layers, the hybrid's ``mamba_rem`` without a remainder)
    has no entry."""
    out = {}
    for k, v in tree.items():
        if SEP in k:
            raise ValueError(f"key {k!r} holds the separator {SEP!r}")
        if v is None:
            continue
        if isinstance(v, Mapping):
            out.update({f"{k}{SEP}{sub}": leaf for sub, leaf in flatten_tree(v).items()})
        else:
            out[k] = v
    return out


def unflatten_tree(flat: Mapping, none: tuple[str, ...] = ()) -> dict:
    """`flatten_tree`'s inverse: the nested tree of a flat dict, with
    ``None`` under each top-level key of ``none`` (the subtrees
    `flatten_tree` dropped)."""
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split(SEP)
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    for k in none:
        if k in out:
            raise ValueError(f"{k!r} holds leaves; it cannot be a None subtree")
        out[k] = None
    return out


def params_from_jax(tree: Mapping, *,
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """The reference's parameters as numpy arrays -> the port's stacked
    parameter dict on ``device`` (values and dtypes unchanged): a flat
    ``{"w": [M, 784, 10], "b": [M, 10]}`` as it is, a nested tree (the
    model zoo's ``{"blocks": {"attn": {...}}, "embed": ...}``) through
    `flatten_tree`."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, copy=True), device=dev)
            for k, v in flatten_tree(tree).items()}


def params_to_jax(params: Mapping[str, torch.Tensor], cfg=None) -> dict:
    """The port's flat parameter dict as the reference's nested tree of
    numpy arrays (`unflatten_tree`), ready for ``jnp.asarray``; with the
    model's config ``cfg``, the reference's ``None`` subtrees given back
    (`repro_torch.models.api.none_subtrees`)."""
    none = ()
    if cfg is not None:
        from repro_torch.models.api import none_subtrees

        none = none_subtrees(cfg)
    return unflatten_tree({k: v.detach().cpu().numpy() for k, v in params.items()}, none)


def state_from_checkpoint(ckpt_dir: str, template: BridgeState,
                          step: int | None = None) -> BridgeState:
    """The reference's plain-path `BridgeState` checkpoint (``step``, default
    the newest) as the port's state, read by `repro_torch.checkpoint` into
    ``template`` (a port trainer's ``init`` state: its parameters' device
    and dtypes).  The plain path only: a template with any carry raises,
    since the reference's carries are laid out otherwise than the port's."""
    from repro_torch import checkpoint

    carries = [f for f in ("comm", "net", "adv", "obs", "trust", "mets")
               if getattr(template, f) is not None]
    if carries:
        raise ValueError(f"a reference checkpoint crosses on the plain path only; the template "
                         f"carries {carries}, which cross only within the port")
    return checkpoint.restore(ckpt_dir, template, step)[0]


def _key(key) -> np.ndarray:
    return prng.PRNGKey(0) if key is None else np.asarray(key, dtype=np.uint32)


def state_from_jax(params_np: Mapping[str, np.ndarray], t: int, *, key=None,
                   comm: tuple[np.ndarray, np.ndarray] | None = None,
                   net: tuple[np.ndarray, ...] | None = None,
                   adv: tuple[np.ndarray, ...] | None = None,
                   obs: tuple[np.ndarray, ...] | None = None,
                   trust: tuple[np.ndarray, ...] | None = None,
                   mets: tuple[np.ndarray, np.ndarray] | None = None,
                   device: str | torch.device = "cuda") -> BridgeState:
    """A `BridgeState` at tick ``t`` holding the reference's parameters and
    its key (``np.asarray(jax_state.key)``; ``PRNGKey(0)`` when None) —
    resumes a JAX trajectory in the port.  ``comm`` is the reference's codec
    carry ``(est, resid)`` as numpy arrays, for a lossy codec; ``net`` its
    runtime's mailbox state (the five arrays of ``MailboxState``, in order),
    for the network runtime; ``adv`` its adversary state (``mean``,
    ``var``, ``dir``, ``count``), for a stateful adversary; ``obs`` its
    trace's ``TraceState`` (the thirteen arrays in order), for a traced
    run; ``trust`` its ``TrustState`` (suspicion, evicted, echo_mism), for
    a run with the trust layer; ``mets`` its ``MetricState`` (``buf``,
    ``count``), for a run with a metrics spec."""
    dev = resolve_device(device)
    key = _key(key)
    return BridgeState(params=params_from_jax(params_np, device=dev), t=int(t), key=key,
                       comm=_carry(CommState, comm, dev), net=_carry(MailboxState, net, dev),
                       adv=_carry(AdvState, adv, dev), obs=_carry(TraceState, obs, dev),
                       trust=_carry(TrustState, trust, dev), mets=_carry(MetricState, mets, dev))


def stream_state_from_jax(params_np: Mapping[str, np.ndarray], t: int, *, key=None,
                          comm=None, net=None, obs: tuple[np.ndarray, ...] | None = None,
                          trust: tuple[np.ndarray, ...] | None = None,
                          mets: tuple[np.ndarray, np.ndarray] | None = None,
                          device: str | torch.device = "cuda") -> BridgeState:
    """A `repro_torch.stream.StreamBridgeTrainer` state from the reference's
    ``StreamBridgeTrainer`` state: ``comm`` its per-leaf codec carries (a
    tuple, one ``(est, resid)`` a leaf in the leaves' sorted-key order),
    ``net`` its ``BlockMailboxState`` as ``(send_tick, (values per
    leaf))``, the rest as in `state_from_jax`."""
    dev = resolve_device(device)
    carries = None if comm is None else tuple(_carry(CommState, c, dev) for c in comm)
    mailbox = None
    if net is not None:
        send_tick, values = net
        mailbox = BlockMailboxState(
            torch.as_tensor(np.array(send_tick, copy=True), device=dev),
            tuple(torch.as_tensor(np.array(v, copy=True), device=dev) for v in values))
    return BridgeState(params=params_from_jax(params_np, device=dev), t=int(t), key=_key(key),
                       comm=carries, net=mailbox, obs=_carry(TraceState, obs, dev),
                       trust=_carry(TrustState, trust, dev), mets=_carry(MetricState, mets, dev))


def _carry(kind, arrays, dev):
    """A carried state of type ``kind`` from its fields as numpy arrays (or
    None)."""
    if arrays is None:
        return None
    return kind(*(torch.as_tensor(np.array(x, copy=True), device=dev) for x in arrays))


def grid_state_from_jax(params_np: Mapping[str, np.ndarray], t, keys, *,
                        net: tuple[np.ndarray, ...] | None = None,
                        comm: tuple[np.ndarray, np.ndarray] | None = None,
                        adv: tuple[np.ndarray, ...] | None = None,
                        obs: tuple[np.ndarray, ...] | None = None,
                        trust: tuple[np.ndarray, ...] | None = None,
                        mets: tuple[np.ndarray, np.ndarray] | None = None,
                        device: str | torch.device = "cuda") -> BridgeState:
    """A `repro_torch.sim.GridEngine` state from the reference's
    ``GridEngine`` state: its stacked ``[E, M, ...]`` parameters, its tick
    (``[E]``, one value every cell shares, or an int) and its ``[E, 2]``
    keys (``np.asarray(jax_state.key)``), in the engine's cell order; for a
    net grid ``net``, its stacked ``MailboxState`` (the five arrays in
    order, ``[E, M, W, ...]``, the ticks int32); for a lossy codec bank
    ``comm``, its stacked carry ``(est, resid)`` (``[E, M, d]``, per link
    ``[E, M, W, d]``); for a stateful adversary bank ``adv``, its stacked
    ``AdvState`` (``[E, d]`` rows, ``count [E]``); for a traced grid
    ``obs``, its stacked ``TraceState`` (the thirteen arrays, ``[E, ...]``,
    the ticks int32); with the trust layer ``trust``, its stacked
    ``TrustState`` (``[E, M, W]`` each); with a metrics spec ``mets``, its
    stacked rings (``buf [E, C, S]``, ``count [E]``)."""
    ticks = np.unique(np.asarray(t))
    if ticks.size != 1:
        raise ValueError(f"the port's grid cells share one tick, got {ticks.tolist()}")
    keys = np.asarray(keys, dtype=np.uint32)
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"grid keys are [E, 2] uint32, got {keys.shape}")
    mailbox = None
    if net is not None:
        dev = resolve_device(device)
        mailbox = MailboxState(*(torch.as_tensor(np.array(x, copy=True), device=dev)
                                 for x in net))
        if mailbox.send_tick.dtype != torch.int32 or mailbox.values.shape[0] != keys.shape[0]:
            raise ValueError(f"a net grid's mailboxes are [E={keys.shape[0]}, M, W, ...] with "
                             f"int32 ticks, got {tuple(mailbox.values.shape)} "
                             f"{mailbox.send_tick.dtype}")
    dev = resolve_device(device)
    carry, adv_state = _carry(CommState, comm, dev), _carry(AdvState, adv, dev)
    trace = _carry(TraceState, obs, dev)
    trust_state = _carry(TrustState, trust, dev)
    rings = _carry(MetricState, mets, dev)
    for name, x in (("comm", carry), ("adv", adv_state), ("obs", trace),
                    ("trust", trust_state), ("mets", rings)):
        if x is not None and x[0].shape[0] != keys.shape[0]:
            raise ValueError(f"a grid's {name} carry leads with E={keys.shape[0]} cells, got "
                             f"{tuple(x[0].shape)}")
    return BridgeState(params=params_from_jax(params_np, device=device), t=int(ticks[0]),
                       key=keys.copy(), comm=carry, net=mailbox, adv=adv_state, obs=trace,
                       trust=trust_state, mets=rings)


def byrdie_state_from_jax(params_np: Mapping[str, np.ndarray], t: int, *, key=None,
                          scalars_sent: float = 0.0,
                          device: str | torch.device = "cuda") -> ByrdieState:
    """A `ByrdieState` at sweep ``t`` holding the reference's parameters, its
    key (``PRNGKey(0)`` when None) and its scalar count."""
    return ByrdieState(params_from_jax(params_np, device=device), int(t), _key(key),
                       float(scalars_sent))


def brdso_state_from_jax(params_np: Mapping[str, np.ndarray], t: int, *, key=None,
                         device: str | torch.device = "cuda") -> BrdsoState:
    """A `BrdsoState` at step ``t`` holding the reference's parameters and
    its key (``PRNGKey(0)`` when None)."""
    return BrdsoState(params_from_jax(params_np, device=device), int(t), _key(key))
