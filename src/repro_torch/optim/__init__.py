"""Optimizers and schedules of the port (`repro_torch.optim.sgd`)."""
from repro_torch.optim.sgd import (
    AdamWState,
    adamw_init,
    adamw_update,
    bridge_schedule,
    constant_schedule,
    cosine_schedule,
    momentum_init,
    momentum_update,
)

__all__ = [
    "AdamWState", "adamw_init", "adamw_update",
    "bridge_schedule", "constant_schedule", "cosine_schedule",
    "momentum_init", "momentum_update",
]
