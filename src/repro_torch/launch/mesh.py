"""The device mesh of the sharded path — port of `repro.launch.mesh` over
`torch.distributed`.

A `Mesh` lays every rank of the world on a grid of named axes, row-major
(rank r sits at ``np.unravel_index(r, shape)``), over
``torch.distributed.device_mesh.init_device_mesh``.  Like JAX's ``Mesh``
it exposes ``shape`` (axis -> size) and ``axis_names``; it also gives the
process group of any set of axes (`Mesh.group`): one axis is the device
mesh's own group, several are flattened into one group whose ranks run
row-major over them, the order of ``lax.axis_index`` over a tuple of axes.
The node axes (``("data",)``, or ``("pod", "data")`` multi-pod) host the
BRIDGE node dimension; ``"model"`` is the tensor-parallel axis inside a
replica (`repro_torch.launch.steps`).

The world comes first: `init_world` starts the default process group
without TCP, over a ``HashStore`` for one process or a ``FileStore`` that
spawned ranks share, on NCCL for ``device="cuda"`` (gloo beside it for CPU
tensors) and gloo for ``device="cpu"``.  A mesh takes exactly the ranks there are:
`make_mesh_compat` raises when the world size is not the product of its
shape, and `make_production_mesh` unless the world is the reference's 256
(one pod) or 512 (two pods) ranks; nothing shrinks a mesh to fit.  One
card means a world of one rank (NCCL refuses two ranks on one device): the
mesh ``(1, 1)``, whose collectives still run through NCCL.
"""
from __future__ import annotations

import datetime
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# a card's world also takes CPU tensors (gloo), so a CPU mesh can hold the
# plain versions beside the card's in one process
_BACKEND = {"cuda": "cpu:gloo,cuda:nccl", "cpu": "gloo"}
# how long a collective waits for the other ranks before the world fails
_TIMEOUT = datetime.timedelta(seconds=600)


def init_world(device: str | torch.device = "cuda", *, rank: int = 0, world_size: int = 1,
               store_path: str | None = None) -> torch.device:
    """Start the default process group: ``world_size`` ranks, this one
    ``rank``, NCCL on a card (CUDA tensors; CPU tensors through gloo) and
    gloo on the CPU.  One rank keeps its
    rendezvous in a ``HashStore``; spawned ranks pass one ``store_path``
    (a file none of them has written yet) to a ``FileStore``.  Returns the
    rank's device (on a card, ``cuda:<rank mod cards>``, made current)."""
    dev = resolve_device(device)
    if dev.type not in _BACKEND:
        raise ValueError(f"no process-group backend for device {dev}")
    if dist.is_initialized():
        raise RuntimeError("the world is already started (close_world first)")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if store_path is None:
        if world_size != 1:
            raise ValueError("spawned ranks rendezvous through a FileStore: pass store_path")
        store = dist.HashStore()
    else:
        store = dist.FileStore(store_path, world_size)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(_BACKEND[dev.type], store=store, rank=rank, world_size=world_size,
                            timeout=_TIMEOUT)
    return dev


def close_world() -> None:
    """Tear the default process group down (a no-op when none is up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Every rank of the world on named axes, row-major.  ``shape`` maps
    axis -> size in axis order, ``axis_names`` lists the axes,
    ``coords`` this rank's coordinate on each, ``device`` its device."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...], device: torch.device):
        from torch.distributed.device_mesh import init_device_mesh

        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape), strict=True))
        self.device = device
        self.rank = dist.get_rank()
        sizes = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.unravel_index(self.rank, sizes)),
                               strict=True))
        self.device_mesh = init_device_mesh(device.type, sizes, mesh_dim_names=self.axis_names)
        self._groups: dict[tuple[str, ...], dist.ProcessGroup] = {}

    def size(self, axes) -> int:
        """The number of ranks over ``axes`` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's coordinate over ``axes``, flattened row-major (the
        reference's ``lax.axis_index(axes)``)."""
        axes = _axes(axes)
        if not axes:
            return 0
        return int(np.ravel_multi_index(tuple(self.coords[a] for a in axes),
                                        tuple(self.shape[a] for a in axes)))

    def group(self, axes) -> dist.ProcessGroup:
        """The process group of this rank's slice along ``axes``: its ranks
        differ only there, and their group ranks run row-major over
        ``axes`` (`index`).  Several axes are made one group on first use;
        every rank asks for the same groups in the same order."""
        axes = _axes(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or not axes:
            raise ValueError(f"axes {axes} are not a non-empty subset of {self.axis_names}")
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        key = tuple(a for a in self.axis_names if a in axes)
        if key != axes:
            raise ValueError(f"axes {axes} must keep the mesh's order {self.axis_names}")
        if key not in self._groups:
            ranks = np.arange(math.prod(self.shape.values())).reshape(tuple(self.shape.values()))
            inner = [self.axis_names.index(a) for a in axes]
            outer = [i for i in range(len(self.axis_names)) if i not in inner]
            slices = ranks.transpose(outer + inner).reshape(-1, math.prod(ranks.shape[i]
                                                                          for i in inner))
            for members in slices:  # each a new_group every rank calls, in one order
                pg = dist.new_group([int(r) for r in members])
                if self.rank in members:
                    self._groups[key] = pg
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"


def make_mesh_compat(shape, axes, *, device: str | torch.device = "cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the ranks of the started world
    (`init_world`); raises unless their count is the product of
    ``shape``."""
    dev = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("no world: start one with repro_torch.launch.mesh.init_world")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape, strict=True))} needs {math.prod(shape)} "
                         f"ranks; the world has {world}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(shape, axes, dev)


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda") -> Mesh:
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``;
    raises unless the world holds its 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} takes {math.prod(shape)} ranks; the world "
                         f"has {world}")
    return make_mesh_compat(shape, axes, device=device)


def node_axes(mesh) -> tuple:
    """Mesh axes hosting the BRIDGE node dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def num_nodes(mesh) -> int:
    return math.prod(mesh.shape[a] for a in node_axes(mesh))


def make_host_mesh(data: int = 2, model: int = 2, *, device: str | torch.device = "cpu") -> Mesh:
    """A ``(data, model)`` mesh over CPU ranks for tests (a world of
    ``data * model`` gloo ranks, `init_world` with ``device="cpu"``)."""
    return make_mesh_compat((data, model), ("data", "model"), device=device)
