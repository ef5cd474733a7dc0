"""Static coordinate-block partitioning of stacked parameter dicts — port
of `repro.stream.blocks`.

`BlockSpec` is the plan the chunk-streaming step iterates over: every leaf
of an ``[M, ...]`` parameter dict is viewed as an ``[M, s]`` coordinate
matrix and cut into blocks of at most ``chunk`` coordinates.  Blocks never
span leaves (a leaf's dtype and its per-leaf carries stay uniform within a
block), so the partition is per leaf, then per ``chunk`` columns, and the
blocks in global order visit exactly the coordinates of
`repro_torch.core.bridge.stack_flatten`, in its order (leaves by sorted
key, the reference's pytree order).

Block starts and sizes are host ints, so each leaf's tail block runs at its
exact size: no padded coordinate enters screening, and per-block trim
fractions and wire-bit counts are exact.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


class LeafPlan(NamedTuple):
    """One leaf's slice of the global coordinate space."""

    key: str  # the leaf's key in the parameter dict
    shape: tuple  # trailing (per-node) shape of the leaf
    dtype: Any  # the leaf's storage dtype, kept on write-back
    size: int  # prod(shape): coordinates a node in this leaf
    offset: int  # global coordinate offset (stack_flatten order)
    block0: int  # global index of this leaf's first block
    num_full: int  # number of chunk-sized blocks
    tail: int  # size of the final partial block (0 when size % chunk == 0)

    @property
    def num_blocks(self) -> int:
        return self.num_full + (1 if self.tail else 0)

    def blocks(self, chunk: int) -> list[tuple[int, int, int]]:
        """``(global block id, start, size)`` of each block, in order."""
        c = min(chunk, self.size)
        out = [(self.block0 + i, i * c, c) for i in range(self.num_full)]
        if self.tail:
            out.append((self.block0 + self.num_full, self.num_full * c, self.tail))
        return out


class BlockSpec(NamedTuple):
    """The full partition: per-leaf plans and the chunk width."""

    leaves: tuple[LeafPlan, ...]
    chunk: int
    num_nodes: int

    @classmethod
    def from_params(cls, params: dict, chunk: int | None) -> BlockSpec:
        """Plan the partition of a stacked ``[M, ...]`` parameter dict.
        ``chunk`` is the most coordinates a block holds; None is one block
        a leaf."""
        if not params:
            raise ValueError("empty parameter dict")
        keys = sorted(params)
        m = params[keys[0]].shape[0]
        plans, offset, block0 = [], 0, 0
        for k in keys:
            leaf = params[k]
            if tuple(leaf.shape[:1]) != (m,):
                raise ValueError(f"leaf leading axis {tuple(leaf.shape[:1])} != node axis ({m},)")
            if not leaf.dtype.is_floating_point:
                raise ValueError(f"non-float leaf dtype {leaf.dtype}: screening is defined over "
                                 f"real coordinates only")
            shape = tuple(leaf.shape[1:])
            size = int(np.prod(shape)) if shape else 1
            c = size if chunk is None else min(int(chunk), size)
            if c < 1:
                raise ValueError(f"chunk must be >= 1, got {chunk}")
            plan = LeafPlan(key=k, shape=shape, dtype=leaf.dtype, size=size, offset=offset,
                            block0=block0, num_full=size // c, tail=size % c)
            plans.append(plan)
            offset += size
            block0 += plan.num_blocks
        return cls(leaves=tuple(plans),
                   chunk=max(p.size for p in plans) if chunk is None else int(chunk),
                   num_nodes=m)

    @property
    def total_dim(self) -> int:
        return sum(p.size for p in self.leaves)

    @property
    def num_blocks(self) -> int:
        return sum(p.num_blocks for p in self.leaves)

    @property
    def max_block(self) -> int:
        """The widest block (<= chunk): the streaming path's peak block width."""
        return max(min(self.chunk, p.size) for p in self.leaves)

    def block_sizes(self) -> tuple[int, ...]:
        """Each block's coordinate count in global block order (what the
        per-block wire-bit accounting sums over)."""
        return tuple(size for p in self.leaves for _, _, size in p.blocks(self.chunk))

    def leaf_mats(self, params: dict, lead: int = 0) -> list[torch.Tensor]:
        """The ``[*lead, M, s]`` coordinate matrices of a matching dict (with
        ``lead`` leading axes, the cells'): reshapes in the leaf's dtype."""
        if sorted(params) != [p.key for p in self.leaves]:
            raise ValueError("parameter dict does not match this BlockSpec")
        return [params[p.key].reshape(*params[p.key].shape[:lead + 1], -1) for p in self.leaves]

    def unflatten(self, mats: list[torch.Tensor], lead: int = 0) -> dict:
        """Per-leaf ``[*lead, M, s]`` matrices back to the parameter dict
        (each in the dtype its matrix holds)."""
        return {p.key: mat.reshape(*mat.shape[:lead + 1], *p.shape)
                for mat, p in zip(mats, self.leaves, strict=True)}
