"""DeepSeek-style MoE transformer — port of `repro.models.moe`: Multi-head
Latent Attention (MLA) and shared + routed experts with top-k token-choice
routing and capacity dropping.

Covers deepseek-v2-236b (160 routed experts, top 6, 2 shared, kv_lora 512)
and deepseek-v3-671b (256 routed, top 8, 1 shared, the MTP head).

* Routing is the reference's sort-based dispatch: the choices sorted by
  expert (stable), each choice's rank within its expert, choices past the
  capacity sent to a scratch slot that is cut off, the experts' products
  dense ``[E, C, d] x [E, d, f]`` einsums.  The top-k takes a stable
  descending sort, so ties go to the lower expert index as in
  ``lax.top_k``.  The combine adds each token's kept contributions from
  a zero in ascending slot order (expert-major), the order XLA's CPU
  scatter-add applies them: deterministic on the card, where an
  ``index_add_`` would order its atomics differently from run to run.
* Training and prefill expand the latent to per-head keys and values;
  decode takes the absorbed form against the compressed ``ckv`` /
  ``krope`` cache, in float32, as the reference does.

Parameters (flat keys): ``dense_blocks/...`` ``[first_dense_layers, ...]``
(absent when there are none: the reference's ``None`` subtree, which
`repro_torch.convert.params_to_jax` gives back), ``moe_blocks/...``
``[L - first_dense_layers, ...]``, ``mtp/...`` with ``cfg.mtp``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

DENSE, MOE = "dense_blocks", "moe_blocks"

# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------


def mla_shapes(cfg: ModelConfig) -> dict:
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    d, r, rq = cfg.d_model, cfg.kv_lora_rank, cfg.q_lora_rank
    return {"wq_a": (d, rq), "q_norm/w": (rq,), "wq_b": (rq, h * (dn + dr)),
            "wkv_a": (d, r + dr), "kv_norm/w": (r,), "wk_b": (r, h * dn), "wv_b": (r, h * dv),
            "wo": (h * dv, d)}


def init_mla(key, cfg: ModelConfig, device) -> dict:
    ks = prng.split(key, 6)
    draws = {"wq_a": 0, "wq_b": 1, "wkv_a": 2, "wk_b": 3, "wv_b": 4, "wo": 5}
    return {k: (L.dense_init(ks[draws[k]], s, cfg.tdtype, device) if k in draws
                else torch.zeros(s, dtype=cfg.tdtype, device=device))
            for k, s in mla_shapes(cfg).items()}


def mla_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = L.rms_norm(x @ p["wq_a"], p["q_norm/w"]) @ p["wq_b"]
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], L.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]
    c_kv = L.rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_norm/w"])
    k_rope = L.apply_rope(kv[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                          cfg.rope_theta)  # [B, S, 1, dr]
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Training and prefill: the latent expanded back to per-head K / V."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = mla_qkv(p, x, cfg, positions)
    k_nope = (c_kv @ p["wk_b"]).reshape(b, s, h, dn)
    v = (c_kv @ p["wv_b"]).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    o = L.chunked_attention(q, k, v, causal=True, kv_chunk=cfg.kv_chunk)
    return o.reshape(b, s, h * dv) @ p["wo"]


def mla_decode(p: dict, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig):
    """One token, the absorbed form against the compressed cache (``ckv
    [B, S, r]``, ``krope [B, S, dr]``, written at ``pos``)."""
    b = x.shape[0]
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = mla_qkv(p, x, cfg, positions)
    ckv, krope = cache["ckv"].clone(), cache["krope"].clone()
    ckv[:, pos:pos + 1] = c_kv_new.to(ckv.dtype)
    krope[:, pos:pos + 1] = k_rope_new[:, :, 0].to(krope.dtype)
    f32 = torch.float32
    # W_uk absorbed into q: q_c [B, 1, H, r]
    q_c = torch.einsum("bqhd,rhd->bqhr", q_nope.to(f32), p["wk_b"].reshape(r, h, dn).to(f32))
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dn + dr)))
    s_c = torch.einsum("bqhr,bkr->bhqk", q_c, ckv.to(f32))
    s_r = torch.einsum("bqhd,bkd->bhqk", q_rope.to(f32), krope.to(f32))
    s = (s_c + s_r) * scale
    valid = torch.arange(ckv.shape[1], device=x.device) < pos + 1
    s = torch.where(valid[None, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    ctx_c = torch.einsum("bhqk,bkr->bqhr", pr, ckv.to(f32))  # [B, 1, H, r]
    o = torch.einsum("bqhr,rhd->bqhd", ctx_c, p["wv_b"].reshape(r, h, dv).to(f32)).to(x.dtype)
    return o.reshape(b, 1, h * dv) @ p["wo"], {"ckv": ckv, "krope": krope}


# ---------------------------------------------------------------------------
# routed experts
# ---------------------------------------------------------------------------


def moe_ffn_shapes(cfg: ModelConfig) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    out = {"router": (d, e), "wg": (e, d, f), "wu": (e, d, f), "wd": (e, f, d)}
    if cfg.num_shared_experts:
        out.update(L.prefixed("shared", L.mlp_shapes(d, f * cfg.num_shared_experts)))
    return out


def init_moe_ffn(key, cfg: ModelConfig, device) -> dict:
    dt = cfg.tdtype
    ks = prng.split(key, 5)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": L.dense_init(ks[0], (d, e), torch.float32, device),
         "wg": L.dense_init(ks[1], (e, d, f), dt, device),
         "wu": L.dense_init(ks[2], (e, d, f), dt, device),
         "wd": L.dense_init(ks[3], (e, f, d), dt, device)}
    if cfg.num_shared_experts:
        p.update(L.prefixed("shared", L.init_mlp(ks[4], d, f * cfg.num_shared_experts, dt,
                                                 device)))
    return p


def _capacity(num_tokens: int, cfg: ModelConfig) -> int:
    c = int(num_tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(c, cfg.top_k)


def route_topk(router_logits: torch.Tensor, cfg: ModelConfig):
    """Token-choice top-k with normalised gates: ``(probs [T, E], gates [T,
    K], experts [T, K])``, ties to the lower expert index."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    return probs, gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True), gate_idx


def dispatch(gate_idx: torch.Tensor, cap: int, cfg: ModelConfig):
    """The sort-based dispatch: each choice's slot (``expert * cap +
    rank``, or the scratch slot ``E * cap`` past the capacity), whether it
    is kept, and each slot's token (``T`` where the slot is empty)."""
    t = gate_idx.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    dev = gate_idx.device
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    lin = torch.arange(t * k, device=dev)
    is_new = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                        sorted_e[1:] != sorted_e[:-1]])
    seg_start = torch.cummax(torch.where(is_new, lin, 0), dim=0).values
    rank = torch.empty_like(lin).scatter_(0, order, lin - seg_start)
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank, e * cap)
    # kept slots are distinct; every overflow lands on the scratch slot, cut off
    slot_tok = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
    slot_tok = slot_tok.scatter_(0, slot, lin // k)[:e * cap]
    return slot, keep, slot_tok


def combine(contrib: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            t: int) -> torch.Tensor:
    """``out[token] = sum of its kept slots' rows of contrib [E C, d]``,
    added from a zero in ascending slot order (the reference's scatter-add
    order on the CPU), each step one elementwise add: the same bits on
    every run."""
    k = slot.shape[0] // t
    slots, perm = torch.sort(slot.reshape(t, k), dim=1)
    kept = torch.gather(keep.reshape(t, k), 1, perm)
    rows = contrib[slots.clamp(max=contrib.shape[0] - 1)]  # [T, K, d]
    out = torch.zeros((t, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        out = torch.where(kept[:, j, None], out + rows[:, j], out)
    return out


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """``x [B, S, d]`` -> ``(out [B, S, d], the load-balance aux loss)``."""
    b, s, d = x.shape
    t = b * s
    e = cfg.num_experts
    cap = _capacity(t, cfg)
    xf = x.reshape(t, d)
    probs, gate_vals, gate_idx = route_topk(xf @ p["router"], cfg)
    slot, keep, slot_tok = dispatch(gate_idx, cap, cfg)
    xf_pad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype, device=xf.device)])
    expert_in = xf_pad[slot_tok].reshape(e, cap, d).to(cfg.tdtype)
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, p["wg"])) * torch.einsum(
        "ecd,edf->ecf", expert_in, p["wu"])
    expert_out = torch.einsum("ecf,efd->ecd", h, p["wd"]).reshape(e * cap, d)
    gate_flat = torch.where(keep, gate_vals.reshape(-1), 0.0)
    slot_gate = torch.zeros((e * cap + 1,), dtype=torch.float32, device=x.device)
    slot_gate = slot_gate.scatter_(0, slot, gate_flat)[:e * cap]
    contrib = expert_out.to(torch.float32) * (slot_gate * (slot_tok < t))[:, None]
    out = combine(contrib, slot, keep, t).to(x.dtype).reshape(b, s, d)
    # the auxiliary load-balance loss (Switch / DeepSeek)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(gate_idx, e).sum(dim=1).to(torch.float32), dim=0)
    aux = e * torch.sum(me * ce)
    if cfg.num_shared_experts:
        out = out + L.mlp(L.sub(p, "shared"), x, "swiglu")
    return out, aux


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def block_shapes(cfg: ModelConfig, *, dense_ffn: bool) -> dict:
    d = cfg.d_model
    out = {"ln1/w": (d,), "ln2/w": (d,), **L.prefixed("attn", mla_shapes(cfg))}
    if dense_ffn:
        out.update(L.prefixed("mlp", L.mlp_shapes(d, cfg.d_ff)))
    else:
        out.update(L.prefixed("moe", moe_ffn_shapes(cfg)))
    return out


def init_block(key, cfg: ModelConfig, device, *, dense_ffn: bool) -> dict:
    dt = cfg.tdtype
    k1, k2 = prng.split(key)
    p = {**L.prefixed("ln1", L.init_norm(cfg.d_model, dt, device)),
         **L.prefixed("attn", init_mla(k1, cfg, device)),
         **L.prefixed("ln2", L.init_norm(cfg.d_model, dt, device))}
    if dense_ffn:
        p.update(L.prefixed("mlp", L.init_mlp(k2, cfg.d_model, cfg.d_ff, dt, device)))
    else:
        p.update(L.prefixed("moe", init_moe_ffn(k2, cfg, device)))
    return p


def none_subtrees(cfg: ModelConfig) -> tuple[str, ...]:
    """The reference tree's ``None`` subtrees: ``dense_blocks`` without
    dense layers."""
    return () if cfg.first_dense_layers else (DENSE,)


def param_shapes(cfg: ModelConfig) -> dict:
    nd = cfg.first_dense_layers
    nm = cfg.num_layers - nd
    out = {}
    if nd:
        out.update({f"{DENSE}/{k}": (nd, *s)
                    for k, s in block_shapes(cfg, dense_ffn=True).items()})
    out.update({f"{MOE}/{k}": (nm, *s) for k, s in block_shapes(cfg, dense_ffn=False).items()})
    d = cfg.d_model
    out.update({"embed": (cfg.vocab_size, d), "head": (d, cfg.vocab_size), "ln_f/w": (d,)})
    if cfg.mtp:
        out.update({"mtp/proj": (2 * d, d), "mtp/ln/w": (d,),
                    **L.prefixed("mtp/block", block_shapes(cfg, dense_ffn=True))})
    return out


def init_params(key, cfg: ModelConfig, *, device: str | torch.device = "cuda") -> dict:
    """The reference's initialisation: layer i from ``split(key, L +
    4)[i]`` (the dense layers first), the embedding from the last key, the
    head from the one before, the MTP head from ``keys[-3]``."""
    dev = resolve_device(device)
    nd = cfg.first_dense_layers
    nm = cfg.num_layers - nd
    keys = prng.split(key, cfg.num_layers + 4)
    params: dict = {}
    for i in range(nd):
        L.put(params, DENSE, (nd,), i, init_block(keys[i], cfg, dev, dense_ffn=True))
    for i in range(nd, cfg.num_layers):
        L.put(params, MOE, (nm,), i - nd, init_block(keys[i], cfg, dev, dense_ffn=False))
    dt, d = cfg.tdtype, cfg.d_model
    params["embed"] = L.dense_init(keys[-1], (cfg.vocab_size, d), dt, dev, scale=0.02)
    params["head"] = L.dense_init(keys[-2], (d, cfg.vocab_size), dt, dev)
    params.update(L.prefixed("ln_f", L.init_norm(d, dt, dev)))
    if cfg.mtp:
        k1, k2 = prng.split(keys[-3])
        params["mtp/proj"] = L.dense_init(k1, (2 * d, d), dt, dev)
        params.update(L.prefixed("mtp/block", init_block(k2, cfg, dev, dense_ffn=True)))
        params.update(L.prefixed("mtp/ln", L.init_norm(d, dt, dev)))
    return params


def _block_fwd(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *, dense_ffn: bool):
    h = L.rms_norm(x, p["ln1/w"])
    x = x + mla_attention(L.sub(p, "attn"), h, cfg, positions)
    h = L.rms_norm(x, p["ln2/w"])
    if dense_ffn:
        return x + L.mlp(L.sub(p, "mlp"), h, "swiglu"), 0.0
    out, aux = moe_ffn(L.sub(p, "moe"), h, cfg)
    return x + out, aux


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, return_hidden: bool = False,
            last_only: bool = False):
    """``tokens [B, S]`` -> ``(logits, aux)`` (and the final hidden state
    before ``ln_f`` with ``return_hidden``)."""
    x = params["embed"][tokens.long()] * dense.embed_scale(cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    nd = cfg.first_dense_layers

    def body(x, aux, name, i, dense_ffn):
        x, a = _block_fwd(cfg, L.at(params, name, i), x, positions, dense_ffn=dense_ffn)
        return x, aux + a

    layers = [(DENSE, i, True) for i in range(nd)]
    layers += [(MOE, i, False) for i in range(cfg.num_layers - nd)]
    for name, i, dense_ffn in layers:
        if cfg.remat:
            x, aux = checkpoint(body, x, aux, name, i, dense_ffn, use_reentrant=False)
        else:
            x, aux = body(x, aux, name, i, dense_ffn)
    hidden = x
    if last_only:
        x = x[:, -1:]
    logits = L.rms_norm(x, params["ln_f/w"]) @ params["head"]
    return (logits, aux, hidden) if return_hidden else (logits, aux)


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy plus ``router_aux_weight`` times the aux
    loss; with ``cfg.mtp`` also ``mtp_weight`` times the MTP head's loss
    (token t + 2 from the hidden state at t and the embedding of t + 1)."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    if not cfg.mtp:
        logits, aux = forward(params, inputs, cfg)
        return L.softmax_xent(logits, labels) + cfg.router_aux_weight * aux
    logits, aux, hidden = forward(params, inputs, cfg, return_hidden=True)
    loss = L.softmax_xent(logits, labels)
    emb_next = params["embed"][inputs[:, 1:].long()] * dense.embed_scale(cfg)
    h_in = torch.cat([L.rms_norm(hidden[:, :-1], params["mtp/ln/w"]), emb_next],
                     dim=-1) @ params["mtp/proj"]
    positions = torch.arange(h_in.shape[1], device=h_in.device)
    h_mtp, _ = _block_fwd(cfg, L.sub(params, "mtp/block"), h_in, positions, dense_ffn=True)
    logits2 = L.rms_norm(h_mtp, params["ln_f/w"]) @ params["head"]
    target = labels[:, 2:] if labels.shape[1] > 2 else labels[:, -1:]
    loss = loss + cfg.mtp_weight * L.softmax_xent(logits2[:, :-1], target)
    return loss + cfg.router_aux_weight * aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    dt = dtype or cfg.tdtype
    nd = cfg.first_dense_layers

    def mk(n):
        return {"ckv": torch.zeros((n, batch, max_len, cfg.kv_lora_rank), dtype=dt, device=dev),
                "krope": torch.zeros((n, batch, max_len, cfg.qk_rope_head_dim), dtype=dt,
                                     device=dev)}

    return {"dense": mk(nd) if nd else None, "moe": mk(cfg.num_layers - nd),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """One token: ``tokens [B, 1]`` -> logits ``[B, 1, V]`` and the new
    cache (MLA's absorbed form; the routed experts over the B tokens)."""
    x = params["embed"][tokens.long()] * dense.embed_scale(cfg)
    pos = int(cache["pos"])
    new = {"pos": cache["pos"] + 1, "dense": None}
    for kind, name, dense_ffn in (("dense", DENSE, True), ("moe", MOE, False)):
        if cache[kind] is None:
            continue
        ckvs, kropes = [], []
        for i in range(cache[kind]["ckv"].shape[0]):
            lp = L.at(params, name, i)
            h = L.rms_norm(x, lp["ln1/w"])
            att, c = mla_decode(L.sub(lp, "attn"), h, {"ckv": cache[kind]["ckv"][i],
                                                       "krope": cache[kind]["krope"][i]}, pos,
                                cfg)
            x = x + att
            h = L.rms_norm(x, lp["ln2/w"])
            x = x + (L.mlp(L.sub(lp, "mlp"), h, "swiglu") if dense_ffn
                     else moe_ffn(L.sub(lp, "moe"), h, cfg)[0])
            ckvs.append(c["ckv"])
            kropes.append(c["krope"])
        new[kind] = {"ckv": torch.stack(ckvs), "krope": torch.stack(kropes)}
    logits = L.rms_norm(x, params["ln_f/w"]) @ params["head"]
    return logits, new

