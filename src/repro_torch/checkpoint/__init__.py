"""Checkpoints of the port in the reference's msgpack layout."""
from repro_torch.checkpoint.msgpack_ckpt import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
