"""The adversary tier of the port (`repro.adversary`): so far only what the
batched grids import, the registry with its ``none`` entry
(`repro_torch.adversary.protocols`)."""
from repro_torch.adversary.protocols import (
    ADVERSARIES,
    THETA_DIM,
    Adversary,
    adversary_bank,
    bank_stateful,
    get_adversary,
)

__all__ = ["ADVERSARIES", "THETA_DIM", "Adversary", "adversary_bank", "bank_stateful",
           "get_adversary"]
