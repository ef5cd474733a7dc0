"""Placement specs for parameters, batches and decode caches — port of
`repro.launch.sharding`, and the cutting of a rank's block.

A spec is a tuple with one entry per dim: ``None`` (not split), an axis
name, or a tuple of names (split over their ranks, row-major), the
counterpart of a ``PartitionSpec``.  A one-name tuple is written as the
name and an empty one as ``None``, as ``PartitionSpec`` normalizes them,
so a spec equals the reference's ``tuple(PartitionSpec)``.  No wrapper
ties a spec to its mesh (the reference's ``named`` / ``NamedSharding``,
which its ``jit`` takes): a caller passes the mesh beside the specs.
Specs come in
the caller's tree: a flat ``/``-keyed dict (the port's parameters, whose
keys are the reference's ``_path_str``) or nested dicts; a leaf is a
tensor, an array or a shape tuple.

The reference's rules (its DESIGN.md §5), kept exactly:

* training parameters carry a leading node axis, split over the mesh's
  node axes (``("pod", "data")`` multi-pod, ``("data",)`` single-pod);
* within a replica, tensor parallelism over ``"model"``: an MoE expert dim
  (found by its size, ``num_experts``, so the router's ``[d, E]`` splits
  too) over ``"model"``; else a row-parallel weight (``_ROW_PARALLEL``)
  its input dim when that is at least ``_MIN_SHARD``; else the last dim of
  at least ``_MIN_SHARD``.  Layer-stack dims (``_n_stack_dims``) never
  split;
* serving parameters have no node axis and the same inner rules;
* decode caches: the batch dim over the node axes when it divides, else
  the sequence dim; the trailing dim over ``"model"`` when it divides.

A dim that does not divide among its ranks is padded as GSPMD pads: each
rank's block is ``ceil(n / k)`` long, the last ones zero-filled past
``n``.  `local_shard` cuts a rank's block, `assemble` puts the blocks of
every rank back together, and `gather_axes` does it with a collective
along some axes (a replica gathered over ``"model"``); each strips the
padding.
"""
from __future__ import annotations

import math
from collections.abc import Callable, Mapping, Sequence
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig

_MIN_SHARD = 512

# Row-parallel projections (Megatron pairing): these weights contract against
# an already-split activation, so their INPUT dim is split; their outputs are
# then partial sums reduced once per block.
_ROW_PARALLEL = ("wo", "wd", "out_proj", "cm_v")


def spec_entry(axes):
    """A spec entry as ``PartitionSpec`` keeps it: a one-name tuple as the
    name, an empty one as None."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes
    return axes


def _shape(leaf) -> tuple[int, ...]:
    return tuple(int(s) for s in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") or (isinstance(x, (tuple, list))
                                   and all(isinstance(s, int) for s in x))


def _map(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts (and lists / tuples) whose
    leaves are tensors, arrays or shape tuples; paths join keys with
    ``/`` (a flat dict's keys are its paths)."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()
                if v is not None}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    raise TypeError(f"no leaf or container at {path!r}: {type(tree).__name__}")


def _inner_spec(shape: tuple, cfg: ModelConfig, model_axis: str, *, skip_lead: int,
                row_parallel: bool = False) -> list:
    """Which (non-node) dim to split over the model axis."""
    dims = [None] * len(shape)
    if cfg.num_experts:  # expert parallelism: split the expert dim
        for i in range(skip_lead, len(shape)):
            if shape[i] == cfg.num_experts:
                dims[i] = model_axis
                return dims
    if row_parallel and len(shape) - skip_lead >= 2 and shape[-2] >= _MIN_SHARD:
        dims[-2] = model_axis
        return dims
    for i in reversed(range(skip_lead, len(shape))):  # column-parallel: last large dim
        if shape[i] >= _MIN_SHARD:
            dims[i] = model_axis
            return dims
    return dims


def _n_stack_dims(path: str, cfg: ModelConfig) -> int:
    """How many leading dims of this parameter leaf are layer-stack dims."""
    if "blocks" in path or "groups" in path or "rem" in path:
        # dense pattern groups are [G, P, ...]; others are [L, ...]
        return 2 if (cfg.pattern and "blocks" in path and cfg.family in ("dense", "vlm")) else 1
    return 0


def param_specs(cfg: ModelConfig, params_shapes: Any, *, node_axes: tuple | None,
                model_axis: str = "model", layout: str = "tp") -> Any:
    """The spec tree of a parameter tree.  ``node_axes`` None: the serving
    layout (no node axis); else every leaf's dim 0 is the node axis.

    ``layout``: ``"tp"`` (default), tensor parallelism over the model axis
    inside each node's replica; ``"dp"``, the replica whole on every model
    rank and the node's batch split over the model axis instead."""
    if layout not in ("tp", "dp"):
        raise ValueError(f"unknown layout {layout!r}; options: tp, dp")

    def leaf_spec(ps, leaf):
        shape = _shape(leaf)
        if layout == "dp":
            inner = [None] * (len(shape) - (1 if node_axes is not None else 0))
        else:
            rp = any(ps.endswith(k) or f"/{k}" in ps for k in _ROW_PARALLEL)
            lead = shape[1:] if node_axes is not None else shape
            inner = _inner_spec(lead, cfg, model_axis, skip_lead=_n_stack_dims(ps, cfg),
                                row_parallel=rp)
        if node_axes is not None:
            return (spec_entry(node_axes), *inner)
        return tuple(inner)

    return _map(leaf_spec, params_shapes)


def train_batch_specs(batch_shapes: Any, node_axes: tuple, *, layout: str = "tp",
                      model_axis: str = "model") -> Any:
    """Training batches are ``[M, B/M, ...]``: the node axis split; under
    the ``"dp"`` layout the per-node batch dim also over the model axis."""
    inner0 = model_axis if layout == "dp" else None
    return _map(lambda _, l: (spec_entry(node_axes), inner0, *([None] * (len(_shape(l)) - 2))),
                batch_shapes)


def serve_batch_specs(batch_shapes: Any, node_axes: tuple, global_batch: int, mesh) -> Any:
    n = math.prod(mesh.shape[a] for a in entry_axes(node_axes))
    lead = spec_entry(node_axes) if global_batch % n == 0 and global_batch >= n else None
    return _map(lambda _, l: (lead, *([None] * (len(_shape(l)) - 1))), batch_shapes)


def cache_specs(cfg: ModelConfig, cache_shapes: Any, *, node_axes: tuple, mesh, batch: int,
                seq_len: int, model_axis: str = "model") -> Any:
    n_nodes = math.prod(mesh.shape[a] for a in entry_axes(node_axes))
    n_model = mesh.shape[model_axis]
    batch_ok = batch % n_nodes == 0 and batch >= n_nodes

    def leaf_spec(_, leaf):
        shape = _shape(leaf)
        dims: list = [None] * len(shape)
        placed = False
        if batch_ok:
            for i, s in enumerate(shape):
                if s == batch:
                    dims[i] = spec_entry(node_axes)
                    placed = True
                    break
        if not placed:
            for i, s in enumerate(shape):
                if s == seq_len and s % n_nodes == 0:
                    dims[i] = spec_entry(node_axes)
                    break
        # model axis on the trailing dim when divisible (and not already used)
        if len(shape) >= 2 and dims[-1] is None and shape[-1] % n_model == 0 \
                and shape[-1] >= n_model:
            dims[-1] = model_axis
        return tuple(dims)

    return _map(leaf_spec, cache_shapes)


# ---------------------------------------------------------------------------
# A rank's block
# ---------------------------------------------------------------------------


def entry_axes(entry) -> tuple[str, ...]:
    """The axes a spec entry splits over (a name, a tuple of names, or
    None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_spec(shape: tuple, spec: Sequence, mesh) -> None:
    if len(spec) != len(shape):
        raise ValueError(f"spec {tuple(spec)} has {len(spec)} entries for a rank-{len(shape)} "
                         f"leaf {shape}")
    used = [a for e in spec for a in entry_axes(e)]
    bad = [a for a in used if a not in mesh.shape]
    if bad or len(set(used)) != len(used):
        raise ValueError(f"spec {tuple(spec)}: axes must be distinct axes of {tuple(mesh.shape)}")


def parts(entry, mesh) -> int:
    """How many blocks a dim of spec entry ``entry`` is cut into."""
    return math.prod(mesh.shape[a] for a in entry_axes(entry))


def block_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape``: each split dim
    ``ceil(n / k)`` long (GSPMD's padding)."""
    shape = tuple(int(s) for s in shape)
    _check_spec(shape, spec, mesh)
    return tuple(-(-n // parts(e, mesh)) for n, e in zip(shape, spec, strict=True))


def _block_index(entry, mesh, coords: Mapping[str, int]) -> int:
    axes = entry_axes(entry)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + int(coords[a])
    return idx


def local_shard(t: torch.Tensor, spec: Sequence, mesh, *,
                coords: Mapping[str, int] | None = None) -> torch.Tensor:
    """The block of the full leaf ``t`` that the rank at ``coords`` (default
    this rank, ``mesh.coords``) holds under ``spec``: a contiguous copy,
    zero-padded past the end of a dim that does not divide."""
    coords = mesh.coords if coords is None else coords
    bshape = block_shape(t.shape, spec, mesh)
    out = t
    pad = False
    for dim, (n, e, c) in enumerate(zip(t.shape, spec, bshape, strict=True)):
        if e is None:
            continue
        lo = _block_index(e, mesh, coords) * c
        hi = min(lo + c, n)
        out = out.narrow(dim, min(lo, n), max(hi - lo, 0))
        pad |= hi - lo != c
    if not pad:
        return out.contiguous()
    block = t.new_zeros(bshape)
    block[tuple(slice(0, s) for s in out.shape)] = out
    return block


def _place(out: torch.Tensor, block: torch.Tensor, spec: Sequence, mesh,
           coords: Mapping[str, int], axes: tuple[str, ...]) -> None:
    """Write ``block`` into the padded ``out`` at its slot along the dims
    whose entries lie in ``axes``."""
    index = []
    for dim, e in enumerate(spec):
        c = block.shape[dim]
        if e is not None and set(entry_axes(e)) <= set(axes):
            lo = _block_index(e, mesh, coords) * c
            index.append(slice(lo, lo + c))
        else:
            index.append(slice(None))
    out[tuple(index)] = block


def assemble(blocks: Sequence[torch.Tensor], spec: Sequence, mesh,
             shape: Sequence[int]) -> torch.Tensor:
    """The full leaf of ``shape`` from every rank's block (``blocks[r]``,
    global rank r, row-major over the mesh), padding stripped."""
    sizes = tuple(mesh.shape.values())
    names = tuple(mesh.shape)
    bshape = block_shape(shape, spec, mesh)
    out = blocks[0].new_empty(tuple(c * parts(e, mesh) for c, e in zip(bshape, spec, strict=True)))
    for r, block in enumerate(blocks):
        coords = dict(zip(names, (int(x) for x in np.unravel_index(r, sizes)), strict=True))
        _place(out, block, spec, mesh, coords, names)
    return out[tuple(slice(0, int(n)) for n in shape)]


def gather_axes(block: torch.Tensor, spec: Sequence, mesh, axes, shape: Sequence[int]) -> torch.Tensor:
    """This rank's block with the dims split over ``axes`` gathered whole
    from the ranks along them (one ``all_gather_into_tensor`` over
    `Mesh.group`), their padding stripped; ``shape`` gives those dims' full
    sizes (the other dims are left as they are).  A dim split over ``axes``
    and other axes together is refused.  Along ranks of one, the block is
    returned as it is."""
    axes = entry_axes(axes)
    split = [d for d, e in enumerate(spec) if set(entry_axes(e)) & set(axes)]
    for d in split:
        if not set(entry_axes(spec[d])) <= set(axes):
            raise ValueError(f"dim {d} of spec {tuple(spec)} is split over axes beyond {axes}")
    if not split:
        return block
    n = mesh.size(axes)
    if n == 1:
        return block
    flat = block.reshape(1, -1).contiguous()
    gathered = flat.new_empty((n, flat.shape[1]))
    dist.all_gather_into_tensor(gathered, flat, group=mesh.group(axes))
    gathered = gathered.view(n, *block.shape)
    full = list(block.shape)
    for d in split:
        full[d] = block.shape[d] * parts(spec[d], mesh)
    out = block.new_empty(full)
    sizes = tuple(mesh.shape[a] for a in axes)
    for i in range(n):
        coords = dict(mesh.coords)
        coords.update(zip(axes, (int(x) for x in np.unravel_index(i, sizes)), strict=True))
        _place(out, gathered[i], spec, mesh, coords, axes)
    del gathered
    if all(out.shape[d] == int(shape[d]) for d in split):
        return out
    index = [slice(None)] * out.ndim
    for d in split:
        index[d] = slice(0, int(shape[d]))
    return out[tuple(index)].contiguous()
