"""Batched serving — port of ``examples/serve.py``, on the card by default
(``--device cpu`` runs the plain versions): prefill a prompt batch, then
decode greedily through the family's cache (`ModelApi.init_cache` /
``decode_step``; the KV cache, MLA's compressed cache, or the SSM state).

    PYTHONPATH=src python -m repro_torch.examples.serve --arch qwen3-4b --tokens 32
    PYTHONPATH=src python -m repro_torch.examples.serve --arch rwkv6-3b --device cpu

As in the reference: the ``.reduced()`` config of ``--arch``, parameters from
``PRNGKey(0)``, prompts (and, for the enc-dec family, audio frames) from
numpy's ``default_rng(0)``; the prompt is prefilled by stepping it through
``decode_step``; the enc-dec family instead encodes the audio into its
cross-attention cache and starts from token 1.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.device import resolve_device, set_numerics, wait
from repro_torch.models import api as model_api


class Generated(NamedTuple):
    ids: np.ndarray  # [B, tokens] greedy token ids
    step_s: list  # each decode step's seconds (host clock to a synchronize)
    prefill_s: float  # the prefill's seconds (the prompt's steps or the encoder)
    finite: bool  # every decode step's logits finite


def generate(api: model_api.ModelApi, params: dict, cfg, *, batch: int = 4,
             prompt_len: int = 32, tokens: int = 32, seed: int = 0) -> Generated:
    """Prefill a batch of ``prompt_len`` prompts drawn from
    ``default_rng(seed)``, then decode ``tokens`` greedy tokens, on the
    parameters' device."""
    dev = next(iter(params.values())).device
    rng = np.random.default_rng(seed)
    cache = api.init_cache(cfg, batch, prompt_len + tokens, device=dev)
    t0 = time.perf_counter()
    if cfg.family == "encdec":
        audio = torch.as_tensor(rng.normal(size=(batch, prompt_len, cfg.d_model)),
                                dtype=torch.float32).to(dev)
        cache = api.extra["prefill_cache"](params, cache, audio, cfg)
        tok = torch.full((batch, 1), 1, dtype=torch.int32, device=dev)
    else:
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                                 dtype=torch.int32).to(dev)
        for t in range(prompt_len):
            logits, cache = api.decode_step(params, cache, prompt[:, t:t + 1], cfg)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    wait(dev)
    prefill_s = time.perf_counter() - t0
    out, step_s = [], []
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(tokens):
        t0 = time.perf_counter()
        logits, cache = api.decode_step(params, cache, tok, cfg)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        finite &= torch.isfinite(logits).all()
        out.append(tok[:, 0])
        wait(dev)
        step_s.append(time.perf_counter() - t0)
    ids = torch.stack(out, dim=1).cpu().numpy()
    return Generated(ids, step_s, prefill_s, bool(finite))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Generated:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    set_numerics()
    cfg = get_config(args.arch).reduced()
    api = model_api.build(cfg)
    params = api.init_params(prng.PRNGKey(0), cfg, device=dev)
    gen = generate(api, params, cfg, batch=args.batch, prompt_len=args.prompt_len,
                   tokens=args.tokens)
    dt = sum(gen.step_s) / args.tokens
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"arch={cfg.name} decoded {args.tokens} tokens x batch {args.batch} "
          f"({dt * 1000:.1f} ms/token on {where}, reduced config)")
    print("sample token ids:", gen.ids[0][:16].tolist())
    return gen


if __name__ == "__main__":
    main()
