"""Whisper-style encoder-decoder (the audio backbone) — port of
`repro.models.encdec`.

As in the reference, the mel spectrogram and the convolutional feature
extractor are a stub: callers hand over frame embeddings ``audio_embeds
[B, S_src, d]``, and one linear ``frontend_proj`` stands in for the conv
stack's output projection.  The transformer encoder is bidirectional; the
causal decoder cross-attends to the encoder's output; positions are
learned tables (``enc_pos`` of `MAX_SOURCE_LEN` rows, ``dec_pos`` of
``max_target_len``); layernorm, biased attention, GELU MLPs and the tied
output head ``embed.T`` are Whisper's.

Parameters (flat keys): ``enc_blocks/...`` ``[encoder_layers, ...]``,
``dec_blocks/...`` ``[num_layers, ...]`` (``self_attn``, ``cross_attn``,
``ln1``, ``ln_x``, ``ln2``, ``mlp``), ``frontend_proj``, ``enc_pos``,
``enc_ln/..``, ``embed``, ``dec_pos``, ``dec_ln/..``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

MAX_SOURCE_LEN = 32768  # the prefill_32k input shape
ENC, DEC = "enc_blocks", "dec_blocks"


def _attn_shapes(cfg: ModelConfig) -> dict:
    return L.attention_shapes(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, bias=True)


def enc_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {**L.prefixed("ln1", L.norm_shapes(d, with_bias=True)),
            **L.prefixed("attn", _attn_shapes(cfg)),
            **L.prefixed("ln2", L.norm_shapes(d, with_bias=True)),
            **L.prefixed("mlp", L.mlp_shapes(d, cfg.d_ff, act="gelu", bias=True))}


def dec_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {**L.prefixed("ln1", L.norm_shapes(d, with_bias=True)),
            **L.prefixed("self_attn", _attn_shapes(cfg)),
            **L.prefixed("ln_x", L.norm_shapes(d, with_bias=True)),
            **L.prefixed("cross_attn", _attn_shapes(cfg)),
            **L.prefixed("ln2", L.norm_shapes(d, with_bias=True)),
            **L.prefixed("mlp", L.mlp_shapes(d, cfg.d_ff, act="gelu", bias=True))}


def _init_attn(key, cfg, device) -> dict:
    return L.init_attention(key, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                            cfg.tdtype, device, bias=True)


def _norm(cfg, device) -> dict:
    return L.init_norm(cfg.d_model, cfg.tdtype, device, with_bias=True)


def init_enc_block(key, cfg: ModelConfig, device) -> dict:
    k1, k2 = prng.split(key)
    return {**L.prefixed("ln1", _norm(cfg, device)),
            **L.prefixed("attn", _init_attn(k1, cfg, device)),
            **L.prefixed("ln2", _norm(cfg, device)),
            **L.prefixed("mlp", L.init_mlp(k2, cfg.d_model, cfg.d_ff, cfg.tdtype, device,
                                           act="gelu", bias=True))}


def init_dec_block(key, cfg: ModelConfig, device) -> dict:
    k1, k2, k3 = prng.split(key, 3)
    return {**L.prefixed("ln1", _norm(cfg, device)),
            **L.prefixed("self_attn", _init_attn(k1, cfg, device)),
            **L.prefixed("ln_x", _norm(cfg, device)),
            **L.prefixed("cross_attn", _init_attn(k2, cfg, device)),
            **L.prefixed("ln2", _norm(cfg, device)),
            **L.prefixed("mlp", L.init_mlp(k3, cfg.d_model, cfg.d_ff, cfg.tdtype, device,
                                           act="gelu", bias=True))}


def param_shapes(cfg: ModelConfig) -> dict:
    d, ne, nd = cfg.d_model, cfg.encoder_layers, cfg.num_layers
    out = {f"{ENC}/{k}": (ne, *s) for k, s in enc_block_shapes(cfg).items()}
    out.update({f"{DEC}/{k}": (nd, *s) for k, s in dec_block_shapes(cfg).items()})
    out.update({"frontend_proj": (d, d), "enc_pos": (MAX_SOURCE_LEN, d),
                "embed": (cfg.vocab_size, d), "dec_pos": (cfg.max_target_len, d)})
    out.update(L.prefixed("enc_ln", L.norm_shapes(d, with_bias=True)))
    out.update(L.prefixed("dec_ln", L.norm_shapes(d, with_bias=True)))
    return out


def init_params(key, cfg: ModelConfig, *, device: str | torch.device = "cuda") -> dict:
    """The reference's initialisation: encoder block i from ``split(key,
    ne + nd + 4)[i]``, decoder block i from ``keys[ne + i]``; from the last
    four keys ``frontend_proj``, ``enc_pos`` (``0.02 * normal``), ``embed``
    and ``dec_pos``."""
    dev = resolve_device(device)
    ne, nd = cfg.encoder_layers, cfg.num_layers
    keys = prng.split(key, ne + nd + 4)
    params: dict = {}
    for i in range(ne):
        L.put(params, ENC, (ne,), i, init_enc_block(keys[i], cfg, dev))
    for i in range(nd):
        L.put(params, DEC, (nd,), i, init_dec_block(keys[ne + i], cfg, dev))
    d, dt = cfg.d_model, cfg.tdtype
    params["frontend_proj"] = L.dense_init(keys[-1], (d, d), dt, dev)
    params["enc_pos"] = prng.normal(keys[-2], (MAX_SOURCE_LEN, d), dev).mul_(0.02).to(dt)
    params["embed"] = L.dense_init(keys[-3], (cfg.vocab_size, d), dt, dev, scale=0.02)
    params["dec_pos"] = prng.normal(keys[-4], (cfg.max_target_len, d), dev).mul_(0.02).to(dt)
    params.update(L.prefixed("enc_ln", _norm(cfg, dev)))
    params.update(L.prefixed("dec_ln", _norm(cfg, dev)))
    return params


def encode(params: dict, audio_embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    s = audio_embeds.shape[1]
    x = audio_embeds @ params["frontend_proj"] + params["enc_pos"][:s]

    def body(x, i):
        lp = L.at(params, ENC, i)
        h = L.apply_norm(L.sub(lp, "ln1"), x, "layernorm")
        attn = L.sub(lp, "attn")
        q, k, v = L.qkv_project(attn, h, cfg.num_heads, cfg.num_kv_heads, cfg.hd)
        o = L.chunked_attention(q, k, v, causal=False, kv_chunk=cfg.kv_chunk)
        x = x + L.attn_output(attn, o)
        h = L.apply_norm(L.sub(lp, "ln2"), x, "layernorm")
        return x + L.mlp(L.sub(lp, "mlp"), h, "gelu")

    for i in range(cfg.encoder_layers):
        x = checkpoint(body, x, i, use_reentrant=False) if cfg.remat else body(x, i)
    return L.apply_norm(L.sub(params, "enc_ln"), x, "layernorm")


def _dec_block(lp: dict, x: torch.Tensor, memory, cfg: ModelConfig, *, self_kv=None,
               pos: int | None = None):
    """A decoder block: full-sequence causal self-attention (training,
    ``self_kv`` None), or one token against the self-attention cache
    ``self_kv = (k, v)`` written at ``pos`` (decode; returns the new
    cache).  ``memory`` is the cross-attention's ``(k, v)``."""
    h = L.apply_norm(L.sub(lp, "ln1"), x, "layernorm")
    sa = L.sub(lp, "self_attn")
    q, k, v = L.qkv_project(sa, h, cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    if self_kv is None:
        o = L.chunked_attention(q, k, v, causal=True, kv_chunk=min(cfg.kv_chunk, x.shape[1]))
        new_kv = None
    else:
        kc, vc = (c.clone() for c in self_kv)
        kc[:, pos:pos + 1] = k.to(kc.dtype)
        vc[:, pos:pos + 1] = v.to(vc.dtype)
        o = L.decode_attention(q, kc, vc, pos + 1)
        new_kv = (kc, vc)
    x = x + L.attn_output(sa, o)
    h = L.apply_norm(L.sub(lp, "ln_x"), x, "layernorm")
    ca = L.sub(lp, "cross_attn")
    b, s, _ = h.shape
    qx = (h @ ca["wq"] + ca["bq"]).reshape(b, s, cfg.num_heads, cfg.hd)
    kxm, vxm = memory  # [B, S_src, H, hd], from the encoder's output (_cross_kv)
    ox = L.chunked_attention(qx, kxm, vxm, causal=False, kv_chunk=cfg.kv_chunk)
    x = x + L.attn_output(ca, ox)
    h = L.apply_norm(L.sub(lp, "ln2"), x, "layernorm")
    return x + L.mlp(L.sub(lp, "mlp"), h, "gelu"), new_kv


def _cross_kv(lp: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    b, s, _ = enc_out.shape
    k = (enc_out @ lp["cross_attn/wk"] + lp["cross_attn/bk"]).reshape(b, s, cfg.num_kv_heads,
                                                                       cfg.hd)
    v = (enc_out @ lp["cross_attn/wv"] + lp["cross_attn/bv"]).reshape(b, s, cfg.num_kv_heads,
                                                                       cfg.hd)
    return k, v


def decode_train(params: dict, enc_out: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    s = tokens.shape[1]
    x = params["embed"][tokens.long()] + params["dec_pos"][:s]

    def body(x, i):
        lp = L.at(params, DEC, i)
        return _dec_block(lp, x, _cross_kv(lp, enc_out, cfg), cfg)[0]

    for i in range(cfg.num_layers):
        x = checkpoint(body, x, i, use_reentrant=False) if cfg.remat else body(x, i)
    x = L.apply_norm(L.sub(params, "dec_ln"), x, "layernorm")
    return x @ params["embed"].T  # the tied output head (Whisper)


def forward(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    enc_out = encode(params, batch["audio_embeds"], cfg)
    return decode_train(params, enc_out, batch["tokens"][:, :-1], cfg)


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    return L.softmax_xent(forward(params, batch, cfg), batch["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# serving: the encoder runs once, the decoder steps with its caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, src_len: int, dtype=None, *,
               device: str | torch.device = "cuda") -> dict:
    """Self-attention caches of ``max_target_len`` and cross caches of
    ``src_len`` (the third argument is the source length, as in the
    reference; `prefill_cache` replaces the cross caches)."""
    dev = resolve_device(device)
    dt = dtype or cfg.tdtype
    nd, t, hkv = cfg.num_layers, cfg.max_target_len, cfg.num_kv_heads
    z = lambda n: torch.zeros((nd, batch, n, hkv, cfg.hd), dtype=dt, device=dev)  # noqa: E731
    return {"self_k": z(t), "self_v": z(t), "cross_k": z(src_len), "cross_v": z(src_len),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill_cache(params: dict, cache: dict, audio_embeds: torch.Tensor,
                  cfg: ModelConfig) -> dict:
    """Run the encoder and fill the cross-attention caches (of the
    encoder's length)."""
    enc_out = encode(params, audio_embeds, cfg)
    ks, vs = zip(*(_cross_kv(L.at(params, DEC, i), enc_out, cfg)
                   for i in range(cfg.num_layers)), strict=True)
    return dict(cache, cross_k=torch.stack(ks).to(cache["cross_k"].dtype),
                cross_v=torch.stack(vs).to(cache["cross_v"].dtype))


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """One token at position ``pos`` (``dec_pos[pos]``: decoding stops at
    ``max_target_len``)."""
    pos = int(cache["pos"])
    if pos >= cfg.max_target_len:
        raise ValueError(f"decoding past max_target_len = {cfg.max_target_len}")
    x = params["embed"][tokens.long()] + params["dec_pos"][pos][None, None]
    nk, nv = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _dec_block(L.at(params, DEC, i), x, (cache["cross_k"][i], cache["cross_v"][i]),
                               cfg, self_kv=(cache["self_k"][i], cache["self_v"][i]), pos=pos)
        nk.append(k)
        nv.append(v)
    x = L.apply_norm(L.sub(params, "dec_ln"), x, "layernorm")
    logits = x @ params["embed"].T
    return logits, dict(cache, self_k=torch.stack(nk), self_v=torch.stack(nv),
                        pos=cache["pos"] + 1)
