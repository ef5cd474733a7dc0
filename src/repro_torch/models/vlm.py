"""Qwen2-VL-style vision-language model (the language backbone) — port of
`repro.models.vlm`.

As in the reference, the ViT encoder and its projector are a stub: callers
hand over patch embeddings ``image_embeds [B, N_img, d]``, which replace the
first ``N_img`` token embeddings.  The backbone is the dense decoder
(`repro_torch.models.dense`) with M-RoPE: three rotary sections (t, h, w)
driven by 3-component positions (text advances all three together; image
patches walk a grid at a constant t).  Like the reference, `merge_embeds`
scales the text embeddings by ``sqrt(d_model)`` and `dense.forward` scales
the merged sequence once more.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

init_params = dense.init_params
init_cache = dense.init_cache
param_shapes = dense.param_shapes


def make_mrope_positions(batch: int, seq: int, n_img: int, grid: int | None = None, *,
                         device: str | torch.device = "cpu") -> torch.Tensor:
    """Default M-RoPE positions, int32 ``[3, B, S]``: the image patches on a
    ``sqrt(N) x sqrt(N)`` grid at t = 0, then the text with t = h = w
    advancing."""
    if grid is None:
        grid = max(math.isqrt(max(n_img, 1)), 1)
    i32 = dict(dtype=torch.int32, device=device)
    img, txt = torch.arange(n_img, **i32), torch.arange(seq - n_img, **i32)
    t = torch.cat([torch.zeros((n_img,), **i32), txt + 1])
    hh = torch.cat([img // grid, txt + grid])
    ww = torch.cat([img % grid, txt + grid])
    return torch.stack([t, hh, ww])[:, None].expand(3, batch, seq)


def merge_embeds(params: dict, tokens: torch.Tensor, image_embeds: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    emb = params["embed"][tokens.long()] * dense.embed_scale(cfg)
    n_img = image_embeds.shape[1]
    return torch.cat([image_embeds.to(emb.dtype), emb[:, n_img:]], dim=1)


def forward(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    tokens = batch["tokens"]
    x = merge_embeds(params, tokens, batch["image_embeds"], cfg)
    mpos = batch.get("mrope_positions")
    if mpos is None:
        mpos = make_mrope_positions(tokens.shape[0], tokens.shape[1],
                                    batch["image_embeds"].shape[1], device=tokens.device)
    return dense.forward(params, tokens, cfg, input_embeds=x, mrope_positions=mpos)


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy over the text positions only (the image
    prefix is masked out)."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    n_img = batch["image_embeds"].shape[1]
    sub = dict(batch, tokens=inputs)
    if "mrope_positions" in batch:
        sub["mrope_positions"] = batch["mrope_positions"][:, :, :-1]
    logits = forward(params, sub, cfg)
    mask = (torch.arange(labels.shape[1], device=labels.device)[None, :] >= n_img)
    return L.softmax_xent(logits, labels, mask.to(torch.float32).expand(labels.shape))


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """One text token with ``t = h = w = pos``."""
    pos = int(cache["pos"])
    mpos = torch.full((3, tokens.shape[0], 1), pos, dtype=torch.int32, device=tokens.device)
    return dense.decode_step(params, cache, tokens, cfg, mrope_positions=mpos)
