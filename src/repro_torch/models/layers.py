"""Shared transformer building blocks — port of `repro.models.layers`, in
plain PyTorch ops.

Conventions, as the reference's:

* parameters are plain dicts of tensors (the port's flat dicts: a block's
  entries under their short names, ``"wq"``, ``"q_norm/w"``); ``init_*``
  functions take a host PRNG key (`repro_torch.prng`) and a ``device``;
* activations: ``x [B, S, D]``; attention heads live in the last-but-one
  axis;
* attention is chunked (an online softmax over KV chunks) so ``[S, S]``
  score matrices are never formed; sliding-window attention restricts each
  query chunk to a banded KV slice.  The algorithm is the reference's, op
  for op, not ``scaled_dot_product_attention``, so parity compares like
  with like.

Differences from the reference, each within the model's stated tolerance
(``tests/test_torch_models.py``): ``rms_norm`` and ``layer_norm`` divide by
an IEEE ``sqrt`` where the reference multiplies by XLA's ``rsqrt`` (ROADMAP
"rsqrt"), and `dense_init` draws through `prng.truncated_normal`
(``torch.erfinv``).  No Pallas kernel lies under the zoo: the products go
to ``torch.matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import prng

# ---------------------------------------------------------------------------
# initializers / norms
# ---------------------------------------------------------------------------


def dense_init(key, shape, dtype: torch.dtype, device, scale: float | None = None) -> torch.Tensor:
    """``scale * truncated_normal(key, -2, 2, shape)`` in float32, cast to
    ``dtype``; ``scale`` defaults to ``1 / sqrt(fan_in)`` (``shape[0]``)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    out = prng.truncated_normal(key, -2.0, 2.0, shape, device).mul_(scale)
    return out if dtype == torch.float32 else out.to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x / torch.sqrt(var + eps)) * (1.0 + weight.to(torch.float32))).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) / torch.sqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)


def init_norm(d: int, dtype: torch.dtype, device, *, with_bias: bool = False) -> dict:
    if with_bias:
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": torch.zeros((d,), dtype=dtype, device=device)}  # rmsnorm stores (weight - 1)


def norm_shapes(d: int, *, with_bias: bool = False) -> dict:
    """The shapes `init_norm` makes."""
    return {"w": (d,), "b": (d,)} if with_bias else {"w": (d,)}


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE / M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(rot_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device)
                            / rot_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rot_dim: int | None = None) -> torch.Tensor:
    """x [..., S, H, Dh]; positions [..., S] (broadcastable)."""
    dh = x.shape[-1]
    rot = rot_dim or dh
    freqs = rope_freqs(rot, theta, x.device)  # [rot/2]
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, rot/2]
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: ``positions3 [3, ..., S]`` = (t, h, w)
    position ids; the rotary half-dims split into three sections, each
    rotated by its own position stream."""
    dh = x.shape[-1]
    half = dh // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to head_dim // 2 = {half}")
    freqs = rope_freqs(dh, theta, x.device)  # [half]
    angs, off = [], 0
    for i, sec in enumerate(sections):
        angs.append(positions3[i][..., None].to(torch.float32) * freqs[off:off + sec])
        off += sec
    ang = torch.cat(angs, dim=-1)[..., None, :]  # [..., S, 1, half]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked attention (flash-style online softmax, GQA)
# ---------------------------------------------------------------------------

_NEG = -1e30


def _expand_kv(k: torch.Tensor, heads_q: int) -> torch.Tensor:
    """GQA: repeat kv heads to match q heads."""
    hkv = k.shape[-2]
    if hkv == heads_q:
        return k
    return torch.repeat_interleave(k, heads_q // hkv, dim=-2)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                      kv_chunk: int = 1024, q_offset: int | None = None,
                      bias_mask=None) -> torch.Tensor:
    """Online-softmax attention over KV chunks: ``q [B, Sq, H, Dh]``, ``k,
    v [B, Sk, Hkv, Dh]``; ``q_offset`` is the absolute position of
    ``q[:, 0]`` (default: q and k aligned suffixes).  The reference's scan
    over chunks as a loop: peak extra memory ``O(Sq kv_chunk)`` a head."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]  # may differ from dh (MLA)
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(dh)
    nchunks = -(-sk // kv_chunk)
    pad = nchunks * kv_chunk - sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = (q * scale).to(torch.float32)
    q_pos = torch.arange(sq, device=q.device) + (q_offset if q_offset is not None else sk - sq)
    m = torch.full((b, h, sq), _NEG, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        kb = kp[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        vb = vp[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        kv_pos = ci * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(torch.float32))
        valid = (kv_pos[None, :] < sk).expand(sq, kv_chunk)
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        if bias_mask is not None:
            valid = valid & bias_mask(q_pos, kv_pos)
        s = torch.where(valid[None, None], s, _NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # [B, Sq, H, Dv]


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
                             q_chunk: int = 512) -> torch.Tensor:
    """Causal attention restricted to a trailing window: each ``q_chunk``
    of queries attends to its static ``[q_chunk + window]`` KV band (the
    KV left-padded by ``window``).  Requires aligned q and k (training,
    prefill)."""
    b, s, h, dh = q.shape
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(dh)
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        raise ValueError(f"sequence {s} is not a multiple of q_chunk {q_chunk}")
    band = window + q_chunk
    kp = F.pad(k, (0, 0, 0, 0, band - q_chunk, 0))
    vp = F.pad(v, (0, 0, 0, 0, band - q_chunk, 0))
    chunks = []
    for ci in range(s // q_chunk):
        q_start = ci * q_chunk
        qb = q[:, q_start:q_start + q_chunk]
        kb = kp[:, q_start:q_start + band]
        vb = vp[:, q_start:q_start + band]
        qpos = q_start + torch.arange(q_chunk, device=q.device)
        kpos = q_start - window + torch.arange(band, device=q.device)
        valid = ((kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - window)
                 & (kpos[None, :] >= 0))
        sco = torch.einsum("bqhd,bkhd->bhqk", (qb * scale).to(torch.float32),
                           kb.to(torch.float32))
        sco = torch.where(valid[None, None], sco, _NEG)
        p = torch.softmax(sco, dim=-1)
        ob = torch.einsum("bhqk,bkhd->bqhd", p, vb.to(torch.float32))
        chunks.append(ob.to(q.dtype))
    return torch.cat(chunks, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len,
                     *, window: int | None = None) -> torch.Tensor:
    """Single-token attention against a ``[B, S, Hkv, Dh]`` cache;
    ``cache_len`` is the number of valid entries (an int, a 0-d tensor or
    ``[B]``)."""
    _, _, h, dh = q.shape
    k = _expand_kv(k_cache, h)
    v = _expand_kv(v_cache, h)
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).to(torch.float32), k.to(torch.float32))
    pos = torch.arange(k.shape[1], device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = cl[:, None] if cl.ndim == 1 else cl.reshape(1, 1)
    valid = pos[None, :] < cl  # [B or 1, S]
    if window is not None:
        valid = valid & (pos[None, :] >= cl - window)
    s = torch.where(valid[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (GQA + optional qk-norm + RoPE variants)
# ---------------------------------------------------------------------------


def attention_shapes(d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
                     qk_norm: bool = False, bias: bool = False) -> dict:
    """The shapes `init_attention` makes, by flat key."""
    out = {"wq": (d_model, n_heads * head_dim), "wk": (d_model, n_kv * head_dim),
           "wv": (d_model, n_kv * head_dim), "wo": (n_heads * head_dim, d_model)}
    if bias:
        out.update(bq=(n_heads * head_dim,), bk=(n_kv * head_dim,), bv=(n_kv * head_dim,),
                   bo=(d_model,))
    if qk_norm:
        out.update({"q_norm/w": (head_dim,), "k_norm/w": (head_dim,)})
    return out


def init_attention(key, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype: torch.dtype, device, *, qk_norm: bool = False,
                   bias: bool = False) -> dict:
    ks = prng.split(key, 6)
    p = {"wq": dense_init(ks[0], (d_model, n_heads * head_dim), dtype, device),
         "wk": dense_init(ks[1], (d_model, n_kv * head_dim), dtype, device),
         "wv": dense_init(ks[2], (d_model, n_kv * head_dim), dtype, device),
         "wo": dense_init(ks[3], (n_heads * head_dim, d_model), dtype, device)}
    for k, shape in attention_shapes(d_model, n_heads, n_kv, head_dim, qk_norm=qk_norm,
                                     bias=bias).items():
        if k not in p:  # biases and the (weight - 1) norms start at zero
            p[k] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def qkv_project(p: dict, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int, *,
                qk_norm: bool = False):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv, head_dim)
    v = v.reshape(b, s, n_kv, head_dim)
    if qk_norm:
        q = rms_norm(q, p["q_norm/w"])
        k = rms_norm(k, p["k_norm/w"])
    return q, k, v


def attn_output(p: dict, o: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = o.shape
    out = o.reshape(b, s, h * dh) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_shapes(d_model: int, d_ff: int, *, act: str = "swiglu", bias: bool = False) -> dict:
    """The shapes `init_mlp` makes."""
    if act == "swiglu":
        return {"wg": (d_model, d_ff), "wu": (d_model, d_ff), "wd": (d_ff, d_model)}
    out = {"wu": (d_model, d_ff), "wd": (d_ff, d_model)}
    if bias:
        out.update(bu=(d_ff,), bd=(d_model,))
    return out


def init_mlp(key, d_model: int, d_ff: int, dtype: torch.dtype, device, *, act: str = "swiglu",
             bias: bool = False) -> dict:
    ks = prng.split(key, 3)
    p = {}
    for i, (k, shape) in enumerate(mlp_shapes(d_model, d_ff, act=act, bias=bias).items()):
        p[k] = (dense_init(ks[i], shape, dtype, device) if k.startswith("w")
                else torch.zeros(shape, dtype=dtype, device=device))
    return p


def mlp(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    if act == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    h = x @ p["wu"]
    if "bu" in p:
        h = h + p["bu"]
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    out = h @ p["wd"]
    if "bd" in p:
        out = out + p["bd"]
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
