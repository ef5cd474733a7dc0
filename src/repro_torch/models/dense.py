"""Dense decoder-only transformer family — port of `repro.models.dense`.

Covers starcoder2-3b (GELU MLP, layernorm, attention bias), qwen3-4b
(qk-norm), mistral-nemo-12b (128k rope), gemma3-12b (a 5:1 local:global
sliding-window pattern with its own rope theta a kind) and the text
backbone of qwen2-vl (M-RoPE).

Parameters are the port's flat dict: the reference's nested tree with its
path keys joined by ``/`` (``"blocks/attn/wq"``, ``"ln_f/w"``, ``"embed"``).
Every key holds letters, digits and ``_`` only, all above ``/``, so
``sorted(params)`` is the reference's pytree leaf order (sorted keys at each
level), which `repro_torch.core.bridge.stack_flatten`, the stream's
`BlockSpec` and the checkpoints rely on.  Blocks are stacked ``[G, P, ...]``
with ``P = cfg.pattern`` (1 when uniform); the reference's ``lax.scan``
over the G groups is a loop here, the P positions unrolled as there, so
gemma3's local and global layers keep their own windows and thetas.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

BLOCKS = "blocks"


def _pattern(cfg: ModelConfig) -> tuple[int, int]:
    p = cfg.pattern or 1
    if cfg.num_layers % p:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of pattern {p}")
    return cfg.num_layers // p, p


def _is_global(cfg: ModelConfig, pos_in_group: int) -> bool:
    if cfg.pattern and cfg.sliding_window:
        return pos_in_group == cfg.pattern - 1  # gemma3: 5 local then 1 global
    return cfg.sliding_window is None


def _layer_theta(cfg: ModelConfig, is_global: bool) -> float:
    if cfg.rope_theta_local is not None and not is_global:
        return cfg.rope_theta_local
    return cfg.rope_theta


def block_shapes(cfg: ModelConfig) -> dict:
    """One block's leaves (flat keys under ``blocks/``) and their shapes."""
    with_bias = cfg.norm == "layernorm"
    return {**L.prefixed("attn", L.attention_shapes(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                                   cfg.hd, qk_norm=cfg.qk_norm,
                                                   bias=cfg.attn_bias)),
            **L.prefixed("ln1", L.norm_shapes(cfg.d_model, with_bias=with_bias)),
            **L.prefixed("ln2", L.norm_shapes(cfg.d_model, with_bias=with_bias)),
            **L.prefixed("mlp", L.mlp_shapes(cfg.d_model, cfg.d_ff, act=cfg.act,
                                            bias=cfg.attn_bias))}


def param_shapes(cfg: ModelConfig) -> dict:
    """Every leaf of `init_params` and its shape, by flat key (nothing
    allocated): blocks ``[G, P, ...]``."""
    g, p = _pattern(cfg)
    out = {f"{BLOCKS}/{k}": (g, p, *s) for k, s in block_shapes(cfg).items()}
    out.update(embed=(cfg.vocab_size, cfg.d_model), head=(cfg.d_model, cfg.vocab_size))
    out.update(L.prefixed("ln_f", L.norm_shapes(cfg.d_model, with_bias=cfg.norm == "layernorm")))
    return out


def init_block(key, cfg: ModelConfig, device) -> dict:
    dt = cfg.tdtype
    k1, k2 = prng.split(key)
    with_bias = cfg.norm == "layernorm"
    return {**L.prefixed("attn", L.init_attention(k1, cfg.d_model, cfg.num_heads,
                                                 cfg.num_kv_heads, cfg.hd, dt, device,
                                                 qk_norm=cfg.qk_norm, bias=cfg.attn_bias)),
            **L.prefixed("ln1", L.init_norm(cfg.d_model, dt, device, with_bias=with_bias)),
            **L.prefixed("ln2", L.init_norm(cfg.d_model, dt, device, with_bias=with_bias)),
            **L.prefixed("mlp", L.init_mlp(k2, cfg.d_model, cfg.d_ff, dt, device, act=cfg.act,
                                          bias=cfg.attn_bias))}


def init_params(key, cfg: ModelConfig, *, device: str | torch.device = "cuda") -> dict:
    """The reference's initialisation from the host key ``key``: layer i
    from ``split(key, L + 3)[i]``, the embedding from the last key, the head
    from the one before; each layer written into its ``[G, P]`` slot of the
    stacked leaves (no stacked copy)."""
    dev = resolve_device(device)
    g, p = _pattern(cfg)
    keys = prng.split(key, cfg.num_layers + 3)
    shapes = param_shapes(cfg)
    params: dict = {}
    for i in range(cfg.num_layers):
        L.put(params, BLOCKS, (g, p), (i // p, i % p), init_block(keys[i], cfg, dev))
    params["embed"] = L.dense_init(keys[-1], shapes["embed"], cfg.tdtype, dev, scale=0.02)
    params["head"] = L.dense_init(keys[-2], shapes["head"], cfg.tdtype, dev)
    params.update(L.prefixed("ln_f", L.init_norm(cfg.d_model, cfg.tdtype, dev,
                                                with_bias=cfg.norm == "layernorm")))
    return params


def embed_scale(cfg: ModelConfig) -> float:
    """``d_model ** 0.5`` rounded once to float32 (the reference's
    ``jnp.asarray(d ** 0.5, x.dtype)``)."""
    return float(np.float32(cfg.d_model ** 0.5))


def _rope(cfg, q, k, positions, theta, mrope_positions):
    if cfg.mrope and mrope_positions is not None:
        return (L.apply_mrope(q, mrope_positions, theta, cfg.mrope_sections),
                L.apply_mrope(k, mrope_positions, theta, cfg.mrope_sections))
    return L.apply_rope(q, positions, theta), L.apply_rope(k, positions, theta)


def _attention(cfg, p, x, positions, *, is_global, mrope_positions=None):
    q, k, v = L.qkv_project(p, x, cfg.num_heads, cfg.num_kv_heads, cfg.hd, qk_norm=cfg.qk_norm)
    q, k = _rope(cfg, q, k, positions, _layer_theta(cfg, is_global), mrope_positions)
    if is_global or cfg.sliding_window is None:
        o = L.chunked_attention(q, k, v, causal=True, kv_chunk=cfg.kv_chunk)
    else:
        o = L.sliding_window_attention(q, k, v, window=cfg.sliding_window, q_chunk=cfg.q_chunk)
    return L.attn_output(p, o)


def block_apply(cfg, p, x, positions, *, is_global, mrope_positions=None):
    h = L.apply_norm(L.sub(p, "ln1"), x, cfg.norm)
    x = x + _attention(cfg, L.sub(p, "attn"), h, positions, is_global=is_global,
                       mrope_positions=mrope_positions)
    h = L.apply_norm(L.sub(p, "ln2"), x, cfg.norm)
    return x + L.mlp(L.sub(p, "mlp"), h, cfg.act)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, input_embeds=None,
            mrope_positions=None, last_only: bool = False) -> torch.Tensor:
    """``tokens [B, S]`` -> logits ``[B, S, V]`` (``[B, 1, V]`` with
    ``last_only``: the prefill step's output); ``input_embeds`` overrides
    the token embedding lookup (a VLM's prefix)."""
    x = params["embed"][tokens.long()] if input_embeds is None else input_embeds
    if cfg.norm == "rmsnorm":
        x = x * embed_scale(cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    g_count, pat = _pattern(cfg)

    def body(x, g):
        for p in range(pat):
            x = block_apply(cfg, L.at(params, BLOCKS, (g, p)), x, positions,
                            is_global=_is_global(cfg, p), mrope_positions=mrope_positions)
        return x

    for g in range(g_count):
        x = checkpoint(body, x, g, use_reentrant=False) if cfg.remat else body(x, g)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(L.sub(params, "ln_f"), x, cfg.norm)
    return x @ params["head"]


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"] [B, S + 1]`` (with an
    optional ``batch["mask"]``)."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits = forward(params, inputs, cfg)
    mask = batch.get("mask")
    return L.softmax_xent(logits, labels, mask[:, 1:] if mask is not None else None)


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype | None = None, *,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    g, p = _pattern(cfg)
    dt = dtype or cfg.tdtype
    shape = (g, p, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                mrope_positions=None) -> tuple[torch.Tensor, dict]:
    """One-token decode: ``tokens [B, 1]`` -> logits ``[B, 1, V]`` and the
    updated cache (new tensors; the given cache is not written)."""
    x = params["embed"][tokens.long()]
    if cfg.norm == "rmsnorm":
        x = x * embed_scale(cfg)
    pos = int(cache["pos"])
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    g_count, pat = _pattern(cfg)
    nk, nv = cache["k"].clone(), cache["v"].clone()
    for g in range(g_count):
        for p in range(pat):
            sub = L.at(params, BLOCKS, (g, p))
            is_global = _is_global(cfg, p)
            h = L.apply_norm(L.sub(sub, "ln1"), x, cfg.norm)
            attn = L.sub(sub, "attn")
            q, k, v = L.qkv_project(attn, h, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                                    qk_norm=cfg.qk_norm)
            q, k = _rope(cfg, q, k, positions, _layer_theta(cfg, is_global), mrope_positions)
            nk[g, p, :, pos:pos + 1] = k.to(nk.dtype)
            nv[g, p, :, pos:pos + 1] = v.to(nv.dtype)
            window = None if is_global else cfg.sliding_window
            o = L.decode_attention(q, nk[g, p], nv[g, p], pos + 1, window=window)
            x = x + L.attn_output(attn, o)
            h2 = L.apply_norm(L.sub(sub, "ln2"), x, cfg.norm)
            x = x + L.mlp(L.sub(sub, "mlp"), h2, cfg.act)
    x = L.apply_norm(L.sub(params, "ln_f"), x, cfg.norm)
    logits = x @ params["head"]
    return logits, {"k": nk, "v": nv, "pos": cache["pos"] + 1}
