"""Architecture registry — the port's copy of `repro.configs`:
``get_config(arch_id)`` / ``--arch <id>``, the ten configs as data."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import shapes
from repro_torch.configs.deepseek_v2_236b import CONFIG as _dsv2
from repro_torch.configs.deepseek_v3_671b import CONFIG as _dsv3
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.zamba2_1p2b import CONFIG as _zamba2
from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _starcoder2, _zamba2, _qwen3, _whisper, _qwen2vl,
        _rwkv6, _nemo, _dsv2, _dsv3, _gemma3,
    ]
}

SHAPES = shapes.SHAPES


def get_config(arch: str, **overrides) -> ModelConfig:
    try:
        cfg = ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; options: {sorted(ARCHS)}") from None
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = ["ARCHS", "SHAPES", "get_config", "shapes"]
