"""The assigned input shapes — the plain data of `repro.configs.shapes`.

Shapes (from the assignment):
    train_4k       seq_len=  4,096  global_batch=256   (training)
    prefill_32k    seq_len= 32,768  global_batch= 32   (inference-prefill)
    decode_32k     seq_len= 32,768  global_batch=128   (inference-decode)
    long_500k      seq_len=524,288  global_batch=  1   (long-context-decode)

The reference's ``ShapeDtypeStruct`` builders serve its dry-run, which
stays with the JAX package (ROADMAP Queue 1, the lowering matrix); the port
keeps the table and `shape_applicable`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

N_IMAGE_TOKENS = 256  # VLM stub: patch-embedding prefix length


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic path)
LONG_OK = {"zamba2-1.2b", "rwkv6-3b", "gemma3-12b"}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_OK:
        return False, "pure full-attention arch; long_500k skipped"
    if shape.kind == "decode" and cfg.family == "encdec" and shape.name == "long_500k":
        return False, "whisper: no 500k-frame use case"
    return True, ""
