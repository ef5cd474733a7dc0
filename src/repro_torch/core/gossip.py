"""Sharded gossip and screening over the node axes of a mesh — port of
`repro.core.gossip` onto `torch.distributed` (`repro_torch.launch.mesh`).

The node axis of every parameter leaf ``[M, ...]`` is split over the
mesh's node axes (``("data",)`` single-pod, ``("pod", "data")``
multi-pod); the other dims may be split over ``"model"``
(`repro_torch.launch.sharding`).  Each rank holds its block ``[m_loc,
...]`` (``m_loc = M / ranks over the node axes``) and screens its own
coordinate shard: the coordinate-wise rules (BRIDGE-T, BRIDGE-M, DGD's
mean) need nothing from the other ``"model"`` ranks, so only the node axes
communicate, over `Mesh.group`.

Two schedules:

* ``all_gather`` — the paper's broadcast: every rank all-gathers all M
  nodes' values of its shard (``[M, s]``) and screens its own nodes' rows.
  The screen is the views kernels (`repro_torch.kernels.ops.views_*`) over
  the gathered rows expanded with a receiver stride of 0 (``[m_loc, M,
  s]``, read in place) under the rank's adjacency rows, so the work is
  ``m_loc`` nodes' and not M's (rows 1-2's dense form would screen all M
  nodes and keep ``m_loc``).
* ``all_to_all`` — the coordinate-partitioned schedule: the rank's shard
  is split into M coordinate chunks, one ``all_to_all_single`` hands chunk
  r of every node to rank r, which screens it for **all** M receivers in
  one launch of rows 1-2's dense kernels (`screening.screen_all`; the
  reference loops the receivers with ``lax.map`` to keep its peak at
  ``[M, chunk]``, which the kernels never exceed), and a second one hands
  the screened chunks back.

On the CPU every screen is its kernel's plain version, bit for bit the
reference's rules on the same rows.  DGD's mean is plain PyTorch on both
(it has no kernel in the reference), a true division (the reference's
divisor is an operand of the mapped body).

Attacks are the reference's, on the gathered or exchanged rows:
``random`` replaces the Byzantine rows by ``10 * normal(fold_in(fold_in(key,
t), r), shape)`` over the rank's own ``[M, s]`` (r its node-axis index,
`repro_torch.prng`: within a relative 5.8e-6 of ``jax.random``), so the
noise depends on the mesh's shape; ``sign_flip`` by ``-4 x``.
``quantize`` sends int8: one scale a rank's block, ``max(amax, 1e-12) *
float32(1 / 127)`` (XLA folds the constant divisor into its reciprocal),
codes ``round(x / scale)`` (ties to even) clipped to +-127; the gathered
codes are decoded by the ``dequant`` kernel (row 5) in its NaN-keeping
form, the reference's plain ``q * scale`` in every case: a block with a
NaN or inf payload has a scale that is not finite and decodes to NaN
there as in the reference (the screens then rank NaN as +inf; DGD's mean
keeps it).

Vector rules (BRIDGE-K, BRIDGE-B) need the distances between whole
replicas: each rank all-gathers every node's values of each of its leaves'
shards, sums their Gram matrices (``torch.mm``; the reference's is a
``tensordot`` outside any kernel), and all-reduces the sum over the other
axes (a leaf those axes do not split counts once).  Krum's index and
Bulyan's selection loop follow the reference's arithmetic (``1e30`` for
non-peers, ``jnp.sum`` of the ``max(count - b - 2, 1)`` nearest); Krum then
takes the picked replicas from the gathered shards, Bulyan screens its
selection with the trimmed mean of the schedule.

The reference's quirks, kept or refused where it fails:

* ``key=None`` means key 0; no ``byz_mask`` means no Byzantine row;
* ``all_to_all`` takes one node a rank (the reference screens
  ``_flatten_local(x)[0]`` and returns one row a rank): more raise;
* the quantized ``all_gather`` multiplies the gathered codes by the
  gathered scales broadcast as ``gs[:, None]``, one a rank, which the
  reference can do only with one node a rank or one rank: otherwise it
  raises, and so does the port;
* Bulyan's trimmed mean is not quantized; Krum ignores the attack and the
  codec;
* at several nodes a rank the reference's ``all_gather`` screens one row,
  the rank's node-axis index, and returns one row a rank; the port screens
  each of its rows, which equals the reference's result on a mesh of one
  node a rank;
* an unknown schedule raises (the reference runs ``all_to_all`` for any
  name but ``all_gather``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import screening
from repro_torch.kernels import ops, ref

_COORD_RULES = ("trimmed_mean", "median", "mean")
_SCHEDULES = ("all_gather", "all_to_all")
_INV_127 = np.float32(1.0) / np.float32(127.0)
_TINY = 1e-12
_BIG = 1e30


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[rows, ...]`` of each of the group's n ranks stacked in group
    order: ``[n rows, ...]``."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block i of ``x``'s leading dim to the group's rank i; block i of the
    result from rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _inject_attack(vals: torch.Tensor, byz_mask, attack: str, key, t: int,
                   node_index: int) -> torch.Tensor:
    """Substitute the Byzantine rows of the gathered values ``[M, s]``."""
    if attack == "none" or byz_mask is None:
        return vals
    if attack == "random":
        k = prng.fold_in(prng.fold_in(key, t), node_index)
        noise = prng.normal(k, tuple(vals.shape), vals.device).mul_(10.0)
        return torch.where(byz_mask[:, None], noise, vals)
    if attack == "sign_flip":
        return torch.where(byz_mask[:, None], -4.0 * vals, vals)
    raise ValueError(f"attack {attack!r} not supported on the sharded path")


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One symmetric int8 scale for the block ``x``: rank-based screening
    keeps its survivor sets exactly (a shared positive scale is monotone);
    only the averaged magnitudes carry the rounding.  Returns (q int8,
    scale float32 scalar)."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.maximum(amax, amax.new_tensor(_TINY)) * float(_INV_127)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``q [n, s]`` int8 times its row's scale (``scales [n]``): the
    ``dequant`` kernel with zero field 0 and NaN kept, so ``q * scale``
    rounded once, NaN where the reference's product is NaN."""
    n, s = q.shape
    sc = torch.zeros((n, -(-s // ref.SCALE_BLOCK), 2), dtype=torch.float32, device=q.device)
    sc[..., 0] = scales[:, None]
    return ops.dequant(q.contiguous(), sc, keep_nan=True)


def _screen_own(g: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, rule: str,
                b: int) -> torch.Tensor:
    """The all_gather schedule's screen: each of the rank's nodes (``mask
    [m_loc, M]``, ``self_vals [m_loc, s]``) over the gathered ``g [M, s]``,
    read with a receiver stride of 0."""
    if rule == "mean":
        return screening.mean_views(g[None], mask, self_vals, folded=False)
    views = g[None].expand(mask.shape[0], *g.shape)
    return screening.screen_views(views, mask, self_vals, rule=rule, b=b)


def _screen_all_receivers(vals: torch.Tensor, adj: torch.Tensor, rule: str, b: int) -> torch.Tensor:
    """The all_to_all schedule's screen: chunk ``vals [M, c]`` for every
    receiver under ``adj [M, M]``, its own value its row of ``vals``."""
    if rule == "mean":
        return screening.mean_views(vals[None], adj, vals, folded=False)
    return screening.screen_all(vals, adj, rule=rule, b=b)


def _check_leaf(leaf: torch.Tensor, spec, mesh, node_axes, m: int) -> int:
    """Validate a leaf block against its spec and the node count; returns
    ``m_loc``."""
    if leaf.dtype != torch.float32:
        raise TypeError(f"the sharded screens take float32 leaves, got {leaf.dtype}")
    if spec is not None:
        lead = spec[0] if len(spec) else None
        if _axes(lead if lead is not None else ()) != _axes(node_axes):
            raise ValueError(f"spec {tuple(spec)}: dim 0 must be split over the node axes "
                             f"{_axes(node_axes)}")
    n = mesh.size(node_axes)
    if leaf.shape[0] * n != m:
        raise ValueError(f"a block of {leaf.shape[0]} nodes on each of {n} ranks is not the "
                         f"adjacency's {m} nodes")
    return leaf.shape[0]


def _as_mask(x, m: int, device) -> torch.Tensor:
    out = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                          device=device).bool()
    if out.shape[-1] != m:
        raise ValueError(f"a mask of shape {tuple(out.shape)} for {m} nodes")
    return out.contiguous()


@torch.no_grad()
def coordwise_gossip_leaf(
    leaf: torch.Tensor,
    spec,
    *,
    mesh,
    node_axes,
    rule: str,
    b: int,
    adjacency,
    schedule: str = "all_gather",
    byz_mask=None,
    attack: str = "none",
    key=None,
    t: int = 0,
    quantize: bool = False,
) -> torch.Tensor:
    """Screen this rank's block ``[m_loc, ...]`` of one ``[M, ...]`` leaf
    with a coordinate-wise rule; returns the block's screened values."""
    if rule not in _COORD_RULES:
        raise ValueError(f"rule {rule!r} is not coordinate-wise: {_COORD_RULES}")
    if schedule not in _SCHEDULES:
        raise ValueError(f"unknown gossip schedule {schedule!r}; options: {_SCHEDULES}")
    dev = leaf.device
    adj = _as_mask(adjacency, adjacency.shape[0], dev)
    m = adj.shape[0]
    m_loc = _check_leaf(leaf, spec, mesh, node_axes, m)
    n, j, group = mesh.size(node_axes), mesh.index(node_axes), mesh.group(node_axes)
    key = prng.PRNGKey(0) if key is None else key
    t = int(t)
    bm = None if byz_mask is None else _as_mask(byz_mask, m, dev)
    x = leaf.reshape(m_loc, -1)
    if schedule == "all_gather":
        if quantize:
            if n not in (1, m):
                raise ValueError(
                    f"the quantized all_gather broadcasts one scale a rank over the gathered "
                    f"rows (the reference's gs[:, None]): {n} scales cannot scale {m} rows")
            q, scale = _quantize_int8(x)
            gq = _all_gather(q, group, n)
            gs = _all_gather(scale.reshape(1), group, n)
            g = _decode(gq, gs.repeat_interleave(m_loc))
            del gq
        else:
            g = _all_gather(x, group, n)
        g = _inject_attack(g, bm, attack, key, t, j)
        rows = slice(j * m_loc, (j + 1) * m_loc)
        y = _screen_own(g, adj[rows], g[rows].contiguous(), rule, b)
        del g
        return y.reshape(leaf.shape)
    if m_loc != 1:
        raise ValueError(f"the all_to_all schedule takes one node a rank, got {m_loc} (the "
                         f"reference screens only a rank's first node there)")
    s = x[0]
    size = s.shape[0]
    sp = F.pad(s, (0, (-size) % m)).reshape(m, -1)  # [M, chunk]: my coordinates, split
    if quantize:
        q, scale = _quantize_int8(sp)
        vals = _decode(_all_to_all(q, group), _all_gather(scale.reshape(1), group, n))
    else:
        vals = _all_to_all(sp, group)
    # vals[i] = node i's chunk r (r = my node row)
    vals = _inject_attack(vals, bm, attack, key, t, j)
    y_all = _screen_all_receivers(vals, adj, rule, b)
    del vals
    back = _all_to_all(y_all, group)  # back[c] = my screened chunk c
    return back.reshape(-1)[:size].reshape(leaf.shape)


def _node_gram(g: torch.Tensor) -> torch.Tensor:
    """``[M, M]`` Gram matrix of the gathered shard ``g [M, s]``."""
    g = g.float()
    return torch.mm(g, g.T)


def _gathered_rows(block: torch.Tensor, mesh, node_axes) -> torch.Tensor:
    """Every node's values of this rank's coordinate shard: ``[M, s]``."""
    n = mesh.size(node_axes)
    return _all_gather(block.reshape(block.shape[0], -1), mesh.group(node_axes), n)


def _counted_once(spec, mesh, rest: tuple[str, ...]) -> bool:
    """Whether this rank's Gram of a leaf enters the all-reduce: a leaf the
    ``rest`` axes do not split repeats on their ranks, and counts once
    (from coordinate 0 of each such axis)."""
    used = {a for e in (spec or ()) for a in _axes(e if e is not None else ())}
    return all(mesh.coords[a] == 0 for a in rest if a not in used)


def _krum_scores(d2: torch.Tensor, cand: torch.Tensor, self_rows: torch.Tensor,
                 b: int) -> torch.Tensor:
    """Each node j's Krum score of every candidate row (``cand [M, M]``):
    its distances to j's peers (candidates and j), ``1e30`` elsewhere and
    on the diagonal, the ``max(count - b - 2, 1)`` nearest summed;
    ``+inf`` off the candidates.  ``[M, M]``."""
    m = d2.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=d2.device)
    peers = cand | self_rows
    dmat = torch.where(peers[:, None, :], d2[None], _BIG)
    dmat = torch.where(eye[None], _BIG, dmat)
    order = torch.sort(dmat, dim=-1).values
    kk = torch.clamp(cand.sum(dim=-1) - b - 2, min=1)
    take = torch.arange(m, device=d2.device)[None, None, :] < kk[:, None, None]
    scores = torch.where(take, order, 0.0).sum(dim=-1)
    return torch.where(cand, scores, torch.inf)


@torch.no_grad()
def vector_rule_select(params: dict, *, specs: dict, rule: str, b: int, adjacency, mesh,
                       node_axes) -> torch.Tensor:
    """BRIDGE-K's index (``[M]``) or BRIDGE-B's selection mask (``[M, M]``)
    of every node, from the distances between whole replicas: each leaf's
    shard gathered over the node axes, the Gram matrices summed over the
    leaves in key order and all-reduced over the other axes.  ``specs``
    (the leaves' specs) tells which leaves those axes split: a leaf they
    do not split counts once."""
    if rule not in ("krum", "bulyan"):
        raise ValueError(rule)
    nax = _axes(node_axes)
    rest = tuple(a for a in mesh.axis_names if a not in nax)
    dev = next(iter(params.values())).device
    adj = _as_mask(adjacency, adjacency.shape[0], dev)
    m = adj.shape[0]
    gram = torch.zeros((m, m), dtype=torch.float32, device=dev)
    for k in sorted(params):
        g = _gathered_rows(params[k], mesh, nax)
        if _counted_once(specs[k], mesh, rest):
            gram += _node_gram(g)
        del g
    if rest:
        dist.all_reduce(gram, group=mesh.group(rest))
    sq = torch.diagonal(gram)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)
    self_rows = torch.eye(m, dtype=torch.bool, device=dev)
    if rule == "krum":
        return torch.argmin(_krum_scores(d2, adj, self_rows, b), dim=-1)
    n_sel = adj.sum(dim=-1) - 2 * b
    cand = adj.clone()
    sel = torch.zeros_like(adj)
    slots = torch.arange(m, device=dev)
    for step in range(m):
        i_star = torch.argmin(_krum_scores(d2, cand, self_rows, b), dim=-1)
        pick = (slots[None, :] == i_star[:, None]) & (step < n_sel)[:, None]
        cand &= ~pick
        sel |= pick
    return sel


@torch.no_grad()
def gossip_screen_params(
    params: dict,
    specs: dict,
    *,
    mesh,
    node_axes,
    rule: str,
    b: int,
    adjacency,
    schedule: str = "all_gather",
    byz_mask=None,
    attack: str = "none",
    key=None,
    t: int = 0,
    quantize: bool = False,
) -> dict:
    """Screen this rank's blocks of a whole ``[M, ...]`` parameter dict;
    ``specs`` is the matching dict of specs (node axes first)."""
    kw = dict(mesh=mesh, node_axes=node_axes, b=b, schedule=schedule, byz_mask=byz_mask,
              attack=attack, key=key, t=t)
    if rule in _COORD_RULES:
        return {k: coordwise_gossip_leaf(params[k], specs[k], rule=rule, adjacency=adjacency,
                                         quantize=quantize, **kw) for k in params}
    if rule == "krum":
        idx = vector_rule_select(params, specs=specs, rule="krum", b=b, adjacency=adjacency,
                                 mesh=mesh, node_axes=node_axes)
        m_loc = next(iter(params.values())).shape[0]
        j = mesh.index(node_axes)
        mine = idx[j * m_loc:(j + 1) * m_loc]
        out = {}
        for k, block in params.items():
            g = _gathered_rows(block, mesh, _axes(node_axes))
            out[k] = g.index_select(0, mine).reshape(block.shape)
            del g
        return out
    if rule == "bulyan":
        sel = vector_rule_select(params, specs=specs, rule="bulyan", b=b, adjacency=adjacency,
                                 mesh=mesh, node_axes=node_axes)
        # the trimmed mean over the selected set (the selection replaces the
        # adjacency), not quantized
        return {k: coordwise_gossip_leaf(params[k], specs[k], rule="trimmed_mean",
                                         adjacency=sel, **kw) for k in params}
    raise ValueError(f"unknown rule {rule!r}")

