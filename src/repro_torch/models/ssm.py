"""State-space and linear-recurrence families — port of `repro.models.ssm`:
Mamba2 blocks (the hybrid's, `repro_torch.models.hybrid`) and the RWKV6
(Finch) model.

Both recurrences are chunked as in the reference: the intra-chunk work is
batched products over all chunks at once, and only the small state carried
from chunk to chunk runs in a loop (the reference's ``lax.scan``).  Decode
is O(1) in the sequence length: the state is the whole cache.

Parameters are the port's flat dicts (`repro_torch.models.dense`'s
convention): a Mamba2 block's leaves ``norm/w``, ``in_proj``, ``conv_w``,
...; the RWKV model's ``blocks/<leaf>`` stacked ``[L, ...]``.

Two float forms are the reference's own rather than PyTorch's, so that
``a_log`` equals the reference's leaf bit for bit: ``jnp.linspace`` as XLA
compiles it (its constant divisor a reciprocal multiply, the sum an FMA)
and XLA's float32 ``log`` (Cephes' polynomial with FMAs), both on the host
in numpy (`_xla_linspace`, `_xla_log`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# the reference's float forms of a_log (host, numpy float32)
# ---------------------------------------------------------------------------

_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32 (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _xla_linspace(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` (float32) as XLA's CPU compiles
    it: ``step = iota * f32(1 / div)``, ``fma(iota, stop * f32(1 / div),
    start * (1 - step))``, the endpoint appended."""
    a, b = _F32(start), _F32(stop)
    if num == 1:
        return np.array([a], _F32)
    div = num - 1
    c = _F32(_F32(1) / _F32(div))
    i = np.arange(div, dtype=_F32)
    one_minus = (_F32(1) - (i * c).astype(_F32)).astype(_F32)
    out = _fma(i, _F32(b * c), (a * one_minus).astype(_F32))
    return np.concatenate([out, np.array([b], _F32)])


_LOG_P = [_F32(v) for v in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                            -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                            2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]


def _xla_log(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` of positive normal ``x``: Cephes' ``logf``
    polynomial with its multiply-adds fused."""
    x = np.asarray(x, _F32)
    bits = x.view(np.uint32)
    e = ((bits >> 23).astype(np.int32) - 126).astype(_F32)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(_F32)
    low = m < _F32(0.707106781186547524)
    e = (e - low.astype(_F32)).astype(_F32)
    m = ((m - _F32(1)).astype(_F32) + np.where(low, m, _F32(0))).astype(_F32)
    x2 = (m * m).astype(_F32)
    x3 = (x2 * m).astype(_F32)
    p = _LOG_P
    y, y1, y2 = _fma(m, p[0], p[1]), _fma(m, p[3], p[4]), _fma(m, p[6], p[7])
    y, y1, y2 = _fma(y, m, p[2]), _fma(y1, m, p[5]), _fma(y2, m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = (y * x3).astype(_F32)
    y = (y + (e * _F32(-2.12194440e-4)).astype(_F32)).astype(_F32)
    m = (m - (x2 * _F32(0.5)).astype(_F32)).astype(_F32)
    return ((m + y).astype(_F32) + (e * _F32(0.693359375)).astype(_F32)).astype(_F32)


def a_log_init(nh: int) -> np.ndarray:
    """Mamba2's ``log(linspace(1, 16, nh))`` as the reference computes it."""
    return _xla_log(_xla_linspace(1.0, 16.0, nh))


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    din = cfg.mamba_expand * cfg.d_model
    return din, din // cfg.mamba_headdim, cfg.mamba_headdim, cfg.ssm_state


def mamba2_shapes(cfg: ModelConfig) -> dict:
    """One Mamba2 block's leaves and their shapes."""
    d = cfg.d_model
    din, nh, _, n = _mamba_dims(cfg)
    conv_dim = din + 2 * n
    return {"norm/w": (d,), "in_proj": (d, 2 * din + 2 * n + nh),
            "conv_w": (cfg.conv_kernel, conv_dim), "conv_b": (conv_dim,), "a_log": (nh,),
            "d_skip": (nh,), "dt_bias": (nh,), "out_norm/w": (din,), "out_proj": (din, d)}


def init_mamba2(key, cfg: ModelConfig, device) -> dict:
    dt = cfg.tdtype
    d = cfg.d_model
    din, nh, _, n = _mamba_dims(cfg)
    ks = prng.split(key, 4)
    conv_dim = din + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        **L.prefixed("norm", L.init_norm(d, dt, device)),
        "in_proj": L.dense_init(ks[0], (d, 2 * din + 2 * n + nh), dt, device),
        "conv_w": prng.normal(ks[1], (cfg.conv_kernel, conv_dim), device).mul_(0.1).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "a_log": torch.from_numpy(a_log_init(nh)).to(device),
        "d_skip": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        **L.prefixed("out_norm", L.init_norm(din, dt, device)),
        "out_proj": L.dense_init(ks[2], (din, d), dt, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal convolution along time in float32, a loop over the
    kernel's taps: ``x [B, S, C]``, ``w [K, C]``.  With ``state [B, K-1,
    C]`` (decode) it is the left context, and the updated state returns."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].to(torch.float32) * w[i].to(torch.float32)
    out = out + b.to(torch.float32)
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(out).to(x.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _check_chunk(s: int, chunk: int) -> None:
    if s % chunk:
        raise ValueError(f"the chunked recurrence needs the sequence ({s}) to be a multiple of "
                         f"its chunk ({chunk}): a sequence up to 128, or a multiple of 128")


def ssd_chunked(xh, bmat, cmat, dt_a, chunk: int) -> torch.Tensor:
    """Chunked SSD linear recurrence: ``xh [B, S, H, P]``, ``bmat`` /
    ``cmat [B, S, N]`` (one group), ``dt_a [B, S, H]`` the log decay of
    each step (negative) -> ``y [B, S, H, P]``.  Within a chunk a masked
    ``[c, c]`` attention-like product; across chunks the state ``[B, H, P,
    N]`` carries in a loop."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    _check_chunk(s, chunk)
    nc = s // chunk
    xc = xh.reshape(b, nc, chunk, h, p).to(torch.float32)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dt_a.reshape(b, nc, chunk, h), dim=2)  # within-chunk log decay
    # intra-chunk: causal with decay ratios exp(cum_t - cum_s)
    decay = torch.exp(torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :], max=0.0))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    g = torch.einsum("bktn,bksn->bkts", cc, bc)
    w = g[..., None] * decay * causal[None, None, :, :, None]  # [B, nc, t, s, H]
    y_intra = torch.einsum("bktsh,bkshp->bkthp", w, xc)
    # chunk-final states and the carry
    tail = torch.exp(cum[:, :, -1:, :] - cum)
    bx = torch.einsum("bksn,bkshp,bksh->bkhpn", bc, xc, tail)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B, nc, H]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    h_prev = []
    for kk in range(nc):
        h_prev.append(state)
        state = state * chunk_decay[:, kk, :, None, None] + bx[:, kk]
    h_prev = torch.stack(h_prev, dim=1)  # [B, nc, H, P, N], the state entering each chunk
    y_inter = torch.einsum("bktn,bkhpn,bkth->bkthp", cc, h_prev, torch.exp(cum))
    return (y_intra + y_inter).reshape(b, s, h, p)


def _mamba_in(p: dict, x: torch.Tensor, cfg: ModelConfig, conv_state=None):
    din, nh, hp, n = _mamba_dims(cfg)
    h = L.rms_norm(x, p["norm/w"])
    z, xi, bmat, cmat, dt = torch.split(h @ p["in_proj"], [din, din, n, n, nh], dim=-1)
    conv_out, conv_state = _causal_conv(torch.cat([xi, bmat, cmat], dim=-1), p["conv_w"],
                                        p["conv_b"], conv_state)
    xi, bmat, cmat = torch.split(conv_out, [din, n, n], dim=-1)
    return z, xi, bmat, cmat, dt, conv_state


def _mamba_out(p: dict, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = L.rms_norm(y * F.silu(z), p["out_norm/w"])
    return x + y @ p["out_proj"]


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, chunk: int = 128) -> torch.Tensor:
    b, s, _ = x.shape
    din, nh, hp, _ = _mamba_dims(cfg)
    z, xi, bmat, cmat, dt, _ = _mamba_in(p, x, cfg)
    dtv = _softplus(dt.to(torch.float32) + p["dt_bias"])  # [B, S, H]
    dt_a = dtv * -torch.exp(p["a_log"])  # log decay
    xh = (xi.to(torch.float32) * dtv.repeat_interleave(hp, dim=-1)).reshape(b, s, nh, hp)
    y = ssd_chunked(xh, bmat.to(torch.float32), cmat.to(torch.float32), dt_a, chunk)
    y = y + p["d_skip"][None, None, :, None] * xi.reshape(b, s, nh, hp).to(torch.float32)
    return _mamba_out(p, x, y.reshape(b, s, din).to(x.dtype), z)


def mamba2_decode(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """One Mamba2 step: ``state = {"h": [B, H, P, N], "conv": [B, K-1, C]}``."""
    b = x.shape[0]
    din, nh, hp, _ = _mamba_dims(cfg)
    z, xi, bmat, cmat, dt, conv_state = _mamba_in(p, x, cfg, state["conv"])
    dtv = _softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])  # [B, H]
    dec = torch.exp(dtv * -torch.exp(p["a_log"]))
    xh = (xi[:, 0].to(torch.float32) * dtv.repeat_interleave(hp, dim=-1)).reshape(b, nh, hp)
    hs = state["h"] * dec[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", bmat[:, 0].to(torch.float32), xh)
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].to(torch.float32), hs)
    y = y + p["d_skip"][None, :, None] * xi[:, 0].reshape(b, nh, hp).to(torch.float32)
    return _mamba_out(p, x, y.reshape(b, 1, din).to(x.dtype), z), {"h": hs, "conv": conv_state}


def init_mamba_state(cfg: ModelConfig, batch: int, device) -> dict:
    din, nh, hp, n = _mamba_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, nh, hp, n), **f32),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, din + 2 * n), **f32)}


# ---------------------------------------------------------------------------
# RWKV6 (Finch) block
# ---------------------------------------------------------------------------

_LORA = 64


def rwkv6_shapes(cfg: ModelConfig) -> dict:
    """One RWKV6 block's leaves and their shapes."""
    d, f = cfg.d_model, cfg.d_ff
    nh = d // cfg.mamba_headdim  # the rwkv head size reuses mamba_headdim
    return {"ln1/w": (d,), "mu": (5, d), "wr": (d, d), "wk": (d, d), "wv": (d, d),
            "wg": (d, d), "w0": (d,), "w_lora_a": (d, _LORA), "w_lora_b": (_LORA, d),
            "bonus": (nh, cfg.mamba_headdim), "gn/w": (d,), "wo": (d, d), "ln2/w": (d,),
            "cm_mu": (2, d), "cm_k": (d, f), "cm_v": (f, d), "cm_r": (d, d)}


def init_rwkv6(key, cfg: ModelConfig, device) -> dict:
    dt = cfg.tdtype
    shapes = rwkv6_shapes(cfg)
    ks = prng.split(key, 10)
    out = {}
    draws = {"wr": 0, "wk": 1, "wv": 2, "wg": 3, "w_lora_a": 4, "w_lora_b": 5, "wo": 6,
             "cm_k": 7, "cm_v": 8, "cm_r": 9}
    for k, shape in shapes.items():
        if k in draws:
            out[k] = L.dense_init(ks[draws[k]], shape, dt, device,
                                  scale=0.01 if k == "w_lora_b" else None)
        elif k in ("mu", "cm_mu"):  # token-shift mixes
            out[k] = torch.full(shape, 0.5, dtype=dt, device=device)
        elif k == "w0":  # base log-log decay
            out[k] = torch.full(shape, -6.0, dtype=torch.float32, device=device)
        elif k == "bonus":
            out[k] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:  # the (weight - 1) norms
            out[k] = torch.zeros(shape, dtype=dt, device=device)
    return out


def _token_shift(x: torch.Tensor, prev=None) -> torch.Tensor:
    """``x [B, S, D]`` -> the previous token's tensor (zero or ``prev`` as
    the left context)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def wkv6_chunked(r, k, v, w_log, bonus, nh: int, chunk: int = 64) -> torch.Tensor:
    """Chunked WKV6: per-head linear attention with a data-dependent decay
    per channel; ``r, k, v, w_log [B, S, D]``, ``bonus [H, hd]`` -> ``[B,
    S, D]`` float32.  ``y_t = r_t . (S_{t-1} + exp(u) k_t v_t^T)``, ``S_t
    = diag(exp(w_t)) S_{t-1} + k_t v_t^T``, the s < t coefficient factored
    as ``r_t exp(cum_{t-1})`` times ``k_s exp(-cum_s)`` with ``w_log``
    clipped to ``[-1, -1e-6]``, as in the reference: ``exp(-cum)`` grows to
    ``exp(chunk)`` at the clip (inf in float32 past a chunk of 88; the
    reference's blocks pass 128, ROADMAP's standing caveats)."""
    b, s, d = r.shape
    hd = d // nh
    w_log = torch.clamp(w_log, -1.0, -1e-6)
    _check_chunk(s, chunk)
    nc = s // chunk
    shp = (b, nc, chunk, nh, hd)
    rc, kc, vc, wc = (t.to(torch.float32).reshape(shp) for t in (r, k, v, w_log))
    cum = torch.cumsum(wc, dim=2)  # decreasing, <= 0
    a_t = rc * torch.exp(cum - wc)  # exp(cum_{t-1})
    b_s = kc * torch.exp(-cum)
    att = torch.einsum("bkthd,bkshd->bkhts", a_t, b_s)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    att = torch.where(mask[None, None, None], att, 0.0)
    y_intra = torch.einsum("bkhts,bkshd->bkthd", att, vc)
    diag = torch.einsum("bkthd,bkthd->bkth", rc, kc * torch.exp(bonus)[None, None, None])
    y_diag = diag[..., None] * vc
    tail = torch.exp(cum[:, :, -1:] - cum)  # <= 1
    kx = torch.einsum("bkshd,bkshe->bkhde", kc * tail, vc)
    chunk_dec = torch.exp(cum[:, :, -1])  # [B, nc, H, hd]
    state = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=r.device)
    h_prev = []
    for kk in range(nc):
        h_prev.append(state)
        state = state * chunk_dec[:, kk, :, :, None] + kx[:, kk]
    h_prev = torch.stack(h_prev, dim=1)  # [B, nc, H, hd, hd]
    y_inter = torch.einsum("bkthd,bkhde->bkthe", a_t, h_prev)
    return (y_intra + y_diag + y_inter).reshape(b, s, d)


def _decay_log(p: dict, xw: torch.Tensor) -> torch.Tensor:
    return -torch.exp(p["w0"].to(torch.float32)
                      + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).to(torch.float32))


def _channel_mix(p: dict, h2: torch.Tensor, prev2: torch.Tensor) -> torch.Tensor:
    km = h2 + (prev2 - h2) * p["cm_mu"][0]
    rm = h2 + (prev2 - h2) * p["cm_mu"][1]
    vv = torch.square(F.relu(km @ p["cm_k"])) @ p["cm_v"]
    return torch.sigmoid(rm @ p["cm_r"]) * vv


def rwkv6_block(p: dict, x: torch.Tensor, cfg: ModelConfig, chunk: int = 128) -> torch.Tensor:
    s = x.shape[1]
    nh = cfg.d_model // cfg.mamba_headdim
    h = L.rms_norm(x, p["ln1/w"])
    prev = _token_shift(h)
    mix = lambda i: h + (prev - h) * p["mu"][i]  # noqa: E731
    r, k, v = mix(0) @ p["wr"], mix(1) @ p["wk"], mix(2) @ p["wv"]
    g = F.silu(mix(3) @ p["wg"])
    y = wkv6_chunked(r, k, v, _decay_log(p, mix(4)), p["bonus"], nh, chunk=min(chunk, s))
    y = L.rms_norm(y.to(x.dtype), p["gn/w"]) * g
    x = x + y @ p["wo"]
    h2 = L.rms_norm(x, p["ln2/w"])
    return x + _channel_mix(p, h2, _token_shift(h2))


def rwkv6_decode(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """One RWKV6 step: ``state = {"wkv": [B, H, hd, hd], "shift1": [B, D],
    "shift2": [B, D]}``."""
    b, _, d = x.shape
    hd = cfg.mamba_headdim
    nh = d // hd
    h = L.rms_norm(x, p["ln1/w"])[:, 0]
    prev = state["shift1"]
    mix = lambda i: h + (prev - h) * p["mu"][i]  # noqa: E731
    r = (mix(0) @ p["wr"]).reshape(b, nh, hd)
    k = (mix(1) @ p["wk"]).reshape(b, nh, hd)
    v = (mix(2) @ p["wv"]).reshape(b, nh, hd)
    g = F.silu(mix(3) @ p["wg"])
    w_log = torch.clamp(_decay_log(p, mix(4)).reshape(b, nh, hd), -1.0, -1e-6)
    u = p["bonus"].reshape(nh, hd)
    kv = torch.einsum("bhd,bhe->bhde", k.to(torch.float32), v.to(torch.float32))
    y = torch.einsum("bhd,bhde->bhe", r.to(torch.float32),
                     state["wkv"] + torch.exp(u)[None, ..., None] * kv)
    wkv_new = state["wkv"] * torch.exp(w_log)[..., None] + kv
    y = L.rms_norm(y.reshape(b, 1, d).to(x.dtype), p["gn/w"]) * g[:, None]
    x = x + y @ p["wo"]
    h2 = L.rms_norm(x, p["ln2/w"])[:, 0]
    x = x + _channel_mix(p, h2, state["shift2"])[:, None]
    return x, {"wkv": wkv_new, "shift1": h, "shift2": h2}


def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> dict:
    d, hd = cfg.d_model, cfg.mamba_headdim
    return {"wkv": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32, device=device),
            "shift1": torch.zeros((batch, d), dtype=cfg.tdtype, device=device),
            "shift2": torch.zeros((batch, d), dtype=cfg.tdtype, device=device)}


# ---------------------------------------------------------------------------
# the RWKV6 model
# ---------------------------------------------------------------------------

BLOCKS = "blocks"


def param_shapes(cfg: ModelConfig) -> dict:
    """Every leaf of `init_params` and its shape (nothing allocated):
    blocks ``[L, ...]``."""
    out = {f"{BLOCKS}/{k}": (cfg.num_layers, *s) for k, s in rwkv6_shapes(cfg).items()}
    out.update({"embed": (cfg.vocab_size, cfg.d_model), "head": (cfg.d_model, cfg.vocab_size),
                "ln_f/w": (cfg.d_model,)})
    return out


def init_params(key, cfg: ModelConfig, *, device: str | torch.device = "cuda") -> dict:
    """The reference's initialisation: layer i from ``split(key, L + 2)[i]``,
    the embedding from the last key, the head from the one before."""
    dev = resolve_device(device)
    keys = prng.split(key, cfg.num_layers + 2)
    params: dict = {}
    for i in range(cfg.num_layers):
        L.put(params, BLOCKS, (cfg.num_layers,), i, init_rwkv6(keys[i], cfg, dev))
    dt = cfg.tdtype
    params["embed"] = L.dense_init(keys[-1], (cfg.vocab_size, cfg.d_model), dt, dev, scale=0.02)
    params["head"] = L.dense_init(keys[-2], (cfg.d_model, cfg.vocab_size), dt, dev)
    params.update(L.prefixed("ln_f", L.init_norm(cfg.d_model, dt, dev)))
    return params


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            last_only: bool = False) -> torch.Tensor:
    x = params["embed"][tokens.long()]

    def body(x, i):
        return rwkv6_block(L.at(params, BLOCKS, i), x, cfg)

    for i in range(cfg.num_layers):
        x = checkpoint(body, x, i, use_reentrant=False) if cfg.remat else body(x, i)
    if last_only:
        x = x[:, -1:]
    return L.rms_norm(x, params["ln_f/w"]) @ params["head"]


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    tokens = batch["tokens"]
    return L.softmax_xent(forward(params, tokens[:, :-1], cfg), tokens[:, 1:])


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, dtype=None, *,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    state = init_rwkv_state(cfg, batch, dev)
    return {"state": {k: v[None].repeat(cfg.num_layers, *([1] * v.ndim))
                      for k, v in state.items()},
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """One token: ``tokens [B, 1]`` -> logits ``[B, 1, V]`` and the new
    cache (the given one is not written)."""
    x = params["embed"][tokens.long()]
    states = []
    for i in range(cfg.num_layers):
        st = {k: v[i] for k, v in cache["state"].items()}
        x, st = rwkv6_decode(L.at(params, BLOCKS, i), x, st, cfg)
        states.append(st)
    logits = L.rms_norm(x, params["ln_f/w"]) @ params["head"]
    new = {k: torch.stack([st[k] for st in states]) for k in cache["state"]}
    return logits, {"state": new, "pos": cache["pos"] + 1}
