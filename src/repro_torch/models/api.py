"""Uniform model API — port of `repro.models.api`: a family exposes

    init_params(key, cfg, device=)        -> flat parameter dict
    train_loss(params, batch, cfg)        -> scalar loss
    init_cache(cfg, batch, max_len, device=) -> decode cache
    decode_step(params, cache, tok, cfg)  -> (logits, new cache)

`build(cfg)` returns a `ModelApi` dispatching on ``cfg.family``: the
dense decoders (`repro_torch.models.dense`), DeepSeek's MoE with MLA
(`moe`), RWKV6 (`ssm`), the Mamba2 hybrid (`hybrid`), the Whisper
encoder-decoder (`encdec`) and Qwen2-VL (`vlm`).  ``extra`` holds the
reference's family-specific entries: ``prefill_cache`` and ``encode``
(enc-dec), ``make_mrope_positions`` (VLM), ``moe_ffn`` (MoE).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

import torch

from repro_torch.models import dense, encdec, hybrid, moe, ssm, vlm
from repro_torch.models.config import ModelConfig

_FAMILIES = {"dense": dense, "moe": moe, "rwkv": ssm, "hybrid": hybrid, "encdec": encdec,
             "vlm": vlm}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init_params: Callable
    train_loss: Callable
    init_cache: Callable
    decode_step: Callable
    param_shapes: Callable
    extra: dict = dataclasses.field(default_factory=dict)

    def grad_fn(self) -> Callable:
        """The trainers' contract (`repro_torch.core.bridge.BridgeTrainer`,
        `repro_torch.stream.StreamBridgeTrainer`): ``(params [M, ...],
        batch) -> (losses [M], grads [M, ...])``, each node's ``f_j`` and
        its gradient over its own batch ``batch["tokens"][j]`` (the
        reference's ``value_and_grad`` under ``vmap``).

        One ``torch.autograd`` pass a node, in a loop: at full width the
        nodes' activations would not fit side by side (``torch.func.vmap``
        holds all M sets), where a loop holds one node's.  Each node's
        parameters are views of the stacked leaves (no copy), and its
        gradient is written into the ``[M, ...]`` output as soon as it is
        taken, so the peak is the output, one node's gradient and one
        node's activations."""
        cfg, loss_fn = self.cfg, self.train_loss

        def fn(params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
            keys = sorted(params)
            m = params[keys[0]].shape[0]
            grads = {k: torch.empty_like(params[k]) for k in keys}
            losses = []
            for j in range(m):
                node = {k: params[k][j].detach().requires_grad_(True) for k in keys}
                loss = loss_fn(node, {k: v[j] for k, v in batch.items()}, cfg)
                gs = torch.autograd.grad(loss, [node[k] for k in keys])
                for k, g in zip(keys, gs, strict=True):
                    grads[k][j] = g
                del gs, node
                losses.append(loss.detach())
            return torch.stack(losses), grads

        return fn


def build(cfg: ModelConfig) -> ModelApi:
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}): {sorted(_FAMILIES)}")
    extra = {}
    if cfg.family == "encdec":
        extra.update(prefill_cache=encdec.prefill_cache, encode=encdec.encode)
    if cfg.family == "vlm":
        extra["make_mrope_positions"] = vlm.make_mrope_positions
    if cfg.family == "moe":
        extra["moe_ffn"] = moe.moe_ffn
    return ModelApi(cfg=cfg, init_params=mod.init_params, train_loss=mod.train_loss,
                    init_cache=mod.init_cache, decode_step=mod.decode_step,
                    param_shapes=mod.param_shapes, extra=extra)


def none_subtrees(cfg: ModelConfig) -> tuple[str, ...]:
    """The top-level keys where the reference's parameter tree holds
    ``None`` (no leaves; the port's flat dict has no entry): MoE's
    ``dense_blocks`` without dense layers, the hybrid's ``mamba_rem``
    without a remainder."""
    fn = getattr(_FAMILIES[cfg.family], "none_subtrees", None)
    return fn(cfg) if fn is not None else ()


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count from the shapes `init_params` would make
    (nothing allocated): the reference's ``eval_shape`` count."""
    return sum(math.prod(s) for s in build(cfg).param_shapes(cfg).values())
