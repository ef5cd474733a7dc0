"""Step functions of the sharded path — port of `repro.launch.steps`.

* `make_train_step` — one BRIDGE iteration (Algorithm 1) over a mesh
  (`repro_torch.launch.mesh`): each rank's nodes' local gradients, the
  gossip and screening over the node axes (`repro_torch.core.gossip`),
  then ``w <- y - rho(t) g`` with ``rho(t) = 1 / (lam (t0 + t))`` in
  float32, the update in float32 cast back to the leaf's dtype.
* `make_prefill_step` — inference prefill: the family's forward, the last
  position's logits (Whisper: the encoder, then the decoder's last
  position).
* `make_serve_step` — one decode step against a cache.

Each rank holds its blocks of the ``[M, ...]`` parameters under
``param_specs`` (`repro_torch.launch.sharding`).  ``gossip_first`` screens
w(t) before the backward pass, as the reference orders it (there for
collective / compute overlap; the screen depends on w(t) only, so the
order leaves the result unchanged).

The local gradients are `repro_torch.models.api.ModelApi.grad_fn` over
the rank's own nodes, one autograd pass a node.  Over ``"model"`` the
reference lets GSPMD partition each replica's forward and backward; here
each rank all-gathers its nodes' replicas over the model axis, runs the
whole replica, and keeps its shard of the gradient, so each model rank
updates its shard of ``y - rho g``.  Screening stays per coordinate
shard, with no traffic over ``"model"``, as in the reference.  Tensor
parallelism inside the zoo's layers (row- and column-parallel matmuls,
expert parallelism) is a later slice (ROADMAP Queue 1).  With one rank
on the model axis the replica is the block itself, never copied.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.gossip import gossip_screen_params
from repro_torch.launch import sharding
from repro_torch.models import api as model_api
from repro_torch.models import dense, encdec, hybrid, moe, ssm, vlm
from repro_torch.models.config import ModelConfig


def step_size(lam: float, t0: float, t) -> float:
    """``rho(t) = 1 / (lam (t0 + t))`` in float32, each operation rounded
    as the reference's traced float32 arithmetic rounds it."""
    f32 = np.float32
    return float(f32(1.0) / (f32(lam) * (f32(t0) + f32(float(t)))))


def _model_axes(mesh, node_axes) -> tuple[str, ...]:
    nax = (node_axes,) if isinstance(node_axes, str) else tuple(node_axes)
    return tuple(a for a in mesh.axis_names if a not in nax)


def make_train_step(
    cfg: ModelConfig,
    mesh,
    node_axes: tuple,
    param_specs: Any,
    adjacency,
    *,
    rule: str = "trimmed_mean",
    num_byzantine: int = 0,
    gossip_schedule: str = "all_gather",
    lam: float = 1.0,
    t0: float = 200.0,
    gossip_first: bool = True,
    gossip_quantize: bool = False,
) -> Callable:
    """Returns ``train_step(params, batch, t) -> (new_params, metrics)``
    over this rank's blocks: ``params`` under ``param_specs``, ``batch``
    its nodes' whole batches (``{"tokens": [m_loc, B, S + 1], ...}``,
    `sharding.train_batch_specs`'s ``"tp"`` layout).  ``metrics["loss"]``
    is the mean of the M nodes' losses, the same on every rank."""
    api = model_api.build(cfg)
    grad_fn = api.grad_fn()
    shapes = api.param_shapes(cfg)
    rest = _model_axes(mesh, node_axes)
    nax = (node_axes,) if isinstance(node_axes, str) else tuple(node_axes)

    def replica(params):
        """Each node's whole replica: the blocks gathered over the model axes."""
        return {k: sharding.gather_axes(v, param_specs[k], mesh, rest, (v.shape[0], *shapes[k]))
                for k, v in params.items()}

    def local_grads(params, batch):
        full = replica(params)
        losses, grads = grad_fn(full, batch)
        del full
        for k in list(grads):  # this rank's shard of each gradient
            spec = param_specs[k]
            if any(set(sharding.entry_axes(e)) & set(rest) for e in spec[1:]):
                grads[k] = sharding.local_shard(grads[k], (None, *spec[1:]), mesh)
        return losses, grads

    def gossip(params, t):
        return gossip_screen_params(
            params, param_specs, mesh=mesh, node_axes=node_axes, rule=rule, b=num_byzantine,
            adjacency=adjacency, schedule=gossip_schedule, t=t, quantize=gossip_quantize)

    def train_step(params, batch, t):
        if gossip_first:
            y = gossip(params, t)
            losses, grads = local_grads(params, batch)
        else:
            losses, grads = local_grads(params, batch)
            y = gossip(params, t)
        rho = step_size(lam, t0, t)
        new = {}
        for k in sorted(params):
            yy, gg = y.pop(k), grads.pop(k)
            if yy.dtype == torch.float32 and gg.dtype == torch.float32:
                new[k] = yy.sub_(gg.mul_(rho))  # rho g rounded, then the subtract
            else:
                new[k] = (yy.float() - rho * gg.float()).to(yy.dtype)
            del yy, gg
        everyone = losses.new_empty((mesh.size(nax) * losses.shape[0],))
        dist.all_gather_into_tensor(everyone, losses.contiguous(), group=mesh.group(nax))
        return new, {"loss": torch.mean(everyone)}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, batch) -> [B, 1, V]``: the last position's
    logits (Whisper: the encoder, then the decoder's last position)."""
    if cfg.family == "dense":
        def step(params, batch):
            return dense.forward(params, batch["tokens"], cfg, last_only=True)
    elif cfg.family == "vlm":
        def step(params, batch):
            tokens = batch["tokens"]
            x = vlm.merge_embeds(params, tokens, batch["image_embeds"], cfg)
            mpos = vlm.make_mrope_positions(tokens.shape[0], tokens.shape[1],
                                            batch["image_embeds"].shape[1], device=tokens.device)
            return dense.forward(params, tokens, cfg, input_embeds=x, mrope_positions=mpos,
                                 last_only=True)
    elif cfg.family == "moe":
        def step(params, batch):
            return moe.forward(params, batch["tokens"], cfg, last_only=True)[0]
    elif cfg.family == "rwkv":
        def step(params, batch):
            return ssm.forward(params, batch["tokens"], cfg, last_only=True)
    elif cfg.family == "hybrid":
        def step(params, batch):
            return hybrid.forward(params, batch["tokens"], cfg, last_only=True)
    elif cfg.family == "encdec":
        def step(params, batch):
            enc_out = encdec.encode(params, batch["audio_embeds"], cfg)
            return encdec.decode_train(params, enc_out, batch["tokens"], cfg)[:, -1:]
    else:
        raise ValueError(cfg.family)
    return torch.no_grad()(step)


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, batch) -> (logits [B, 1, V], cache)``."""
    api = model_api.build(cfg)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        return api.decode_step(params, cache, batch["tokens"], cfg)

    return serve_step
