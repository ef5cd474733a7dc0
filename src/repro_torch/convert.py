"""Weights across from the JAX package, as numpy arrays.

The reference's checkpoint format (`repro.checkpoint.msgpack_ckpt`) needs
``msgpack``, which the card's machine lacks; until the port reads it, a
caller hands over the state as a dict of numpy arrays (``np.asarray`` of
each leaf of the reference's ``state.params``).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.bridge import BridgeState
from repro_torch.device import resolve_device


def params_from_jax(tree: Mapping[str, np.ndarray], *,
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """``{"w": [M, 784, 10], "b": [M, 10]}`` numpy arrays -> the port's
    stacked parameter dict on ``device`` (values and dtypes unchanged)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, copy=True), device=dev) for k, v in tree.items()}


def state_from_jax(params_np: Mapping[str, np.ndarray], t: int, *, seed: int = 0,
                   device: str | torch.device = "cuda") -> BridgeState:
    """A `BridgeState` at tick ``t`` holding the reference's parameters, with
    the attack generator seeded by ``seed`` — resumes a JAX trajectory in
    the port."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return BridgeState(params=params_from_jax(params_np, device=dev), t=int(t), generator=gen)
