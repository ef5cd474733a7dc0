"""Zamba2-style hybrid — port of `repro.models.hybrid`: a stack of Mamba2
blocks with ONE shared attention + MLP block invoked after every
``cfg.attn_every`` of them (its weights reused at each call; the
per-call LoRA deltas left out, as in the reference).

Parameters (flat keys): ``mamba_groups/<leaf>`` stacked ``[G, attn_every,
...]`` with ``G = num_layers // attn_every``; the remainder ``num_layers %
attn_every`` blocks under ``mamba_rem/<leaf>`` ``[rem, ...]`` (none when
the division is exact: the reference's ``None`` subtree, which
`repro_torch.convert.params_to_jax` gives back); ``shared_attn/...`` one
dense block.  At decode time the shared attention keeps a ring buffer of
``min(max_len, sliding_window)`` keys: past the window the cache holds them
out of order, and only the valid count masks them, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import dense, ssm
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

GROUPS, REM, SHARED = "mamba_groups", "mamba_rem", "shared_attn"


def _attn_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, family="dense", pattern=0, sliding_window=None,
                               attn_every=0, qk_norm=False)


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    g = cfg.num_layers // cfg.attn_every
    return g, cfg.num_layers - g * cfg.attn_every


def none_subtrees(cfg: ModelConfig) -> tuple[str, ...]:
    """The reference tree's ``None`` subtrees: ``mamba_rem`` when the
    layers divide into groups exactly."""
    return () if _groups(cfg)[1] else (REM,)


def param_shapes(cfg: ModelConfig) -> dict:
    g, rem = _groups(cfg)
    blk = ssm.mamba2_shapes(cfg)
    out = {f"{GROUPS}/{k}": (g, cfg.attn_every, *s) for k, s in blk.items()}
    if rem:
        out.update({f"{REM}/{k}": (rem, *s) for k, s in blk.items()})
    out.update(L.prefixed(SHARED, dense.block_shapes(_attn_cfg(cfg))))
    out.update({"embed": (cfg.vocab_size, cfg.d_model), "head": (cfg.d_model, cfg.vocab_size),
                "ln_f/w": (cfg.d_model,)})
    return out


def init_params(key, cfg: ModelConfig, *, device: str | torch.device = "cuda") -> dict:
    """The reference's initialisation: Mamba2 block i from ``split(key, L +
    3)[i]`` (the grouped ones first, then the remainder), the shared block
    from ``keys[-3]``, the embedding from the last key, the head from the
    one before."""
    dev = resolve_device(device)
    g, rem = _groups(cfg)
    ae = cfg.attn_every
    keys = prng.split(key, cfg.num_layers + 3)
    params: dict = {}
    for i in range(g * ae):
        L.put(params, GROUPS, (g, ae), (i // ae, i % ae), ssm.init_mamba2(keys[i], cfg, dev))
    for i in range(rem):
        L.put(params, REM, (rem,), i, ssm.init_mamba2(keys[g * ae + i], cfg, dev))
    params.update(L.prefixed(SHARED, dense.init_block(keys[-3], _attn_cfg(cfg), dev)))
    dt = cfg.tdtype
    params["embed"] = L.dense_init(keys[-1], (cfg.vocab_size, cfg.d_model), dt, dev, scale=0.02)
    params["head"] = L.dense_init(keys[-2], (cfg.d_model, cfg.vocab_size), dt, dev)
    params.update(L.prefixed("ln_f", L.init_norm(cfg.d_model, dt, dev)))
    return params


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            last_only: bool = False) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    s = tokens.shape[1]
    positions = torch.arange(s, device=x.device)
    acfg = _attn_cfg(cfg)
    shared = L.sub(params, SHARED)
    g, rem = _groups(cfg)

    def body(x, gi):
        for i in range(cfg.attn_every):
            x = ssm.mamba2_forward(L.at(params, GROUPS, (gi, i)), x, cfg, chunk=min(128, s))
        return dense.block_apply(acfg, shared, x, positions, is_global=True)

    for gi in range(g):
        x = checkpoint(body, x, gi, use_reentrant=False) if cfg.remat else body(x, gi)
    for i in range(rem):
        x = ssm.mamba2_forward(L.at(params, REM, i), x, cfg, chunk=min(128, s))
    if last_only:
        x = x[:, -1:]
    return L.rms_norm(x, params["ln_f/w"]) @ params["head"]


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    tokens = batch["tokens"]
    return L.softmax_xent(forward(params, tokens[:, :-1], cfg), tokens[:, 1:])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    g, rem = _groups(cfg)
    dt = dtype or cfg.tdtype
    mstate = ssm.init_mamba_state(cfg, batch, dev)
    cache_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (g, batch, cache_len, cfg.num_kv_heads, cfg.hd)
    return {
        "mamba": {k: v.expand(g, cfg.attn_every, *v.shape).clone() for k, v in mstate.items()},
        "mamba_rem": ({k: v.expand(rem, *v.shape).clone() for k, v in mstate.items()}
                      if rem else None),
        "attn_k": torch.zeros(shape, dtype=dt, device=dev),
        "attn_v": torch.zeros(shape, dtype=dt, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """One token: ``tokens [B, 1]`` -> logits ``[B, 1, V]`` and the new
    cache; the shared attention writes slot ``pos % cache_len`` of its ring
    and attends to ``min(pos + 1, cache_len)`` entries."""
    x = params["embed"][tokens.long()]
    pos = int(cache["pos"])
    acfg = _attn_cfg(cfg)
    cache_len = cache["attn_k"].shape[2]
    slot = pos % cache_len
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    sp = L.sub(params, SHARED)
    attn = L.sub(sp, "attn")
    g, rem = _groups(cfg)
    nk, nv = cache["attn_k"].clone(), cache["attn_v"].clone()
    mstates = {k: v.clone() for k, v in cache["mamba"].items()}
    for gi in range(g):
        for i in range(cfg.attn_every):
            st = {k: v[gi, i] for k, v in cache["mamba"].items()}
            x, st = ssm.mamba2_decode(L.at(params, GROUPS, (gi, i)), x, st, cfg)
            for k, v in st.items():
                mstates[k][gi, i] = v
        h = L.apply_norm(L.sub(sp, "ln1"), x, acfg.norm)
        q, k, v = L.qkv_project(attn, h, cfg.num_heads, cfg.num_kv_heads, cfg.hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        nk[gi, :, slot:slot + 1] = k.to(nk.dtype)
        nv[gi, :, slot:slot + 1] = v.to(nv.dtype)
        o = L.decode_attention(q, nk[gi], nv[gi], min(pos + 1, cache_len))
        x = x + L.attn_output(attn, o)
        h2 = L.apply_norm(L.sub(sp, "ln2"), x, acfg.norm)
        x = x + L.mlp(L.sub(sp, "mlp"), h2, acfg.act)
    new = dict(cache, mamba=mstates, attn_k=nk, attn_v=nv, pos=cache["pos"] + 1)
    if rem:
        rstates = {k: v.clone() for k, v in cache["mamba_rem"].items()}
        for i in range(rem):
            st = {k: v[i] for k, v in cache["mamba_rem"].items()}
            x, st = ssm.mamba2_decode(L.at(params, REM, i), x, st, cfg)
            for k, v in st.items():
                rstates[k][i] = v
        new["mamba_rem"] = rstates
    logits = L.rms_norm(x, params["ln_f/w"]) @ params["head"]
    return logits, new
