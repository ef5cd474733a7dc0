"""The adversary tier of the port (`repro.adversary`): the stateful
`Adversary` protocol and its banks (`protocols`), the adaptive adversaries
(`adaptive`: ``alie_online``, ``ipm``, ``dissensus``, ``inner_max``) and the
protocol-level ones (`equivocation`: ``equivocate``, ``slander``), each
registered on import, over the grids' stacked cells."""
from repro_torch.adversary import adaptive as _adaptive  # noqa: F401  (registers)
from repro_torch.adversary import equivocation as _equivocation  # noqa: F401  (registers)
from repro_torch.adversary.protocols import (
    ADVERSARIES,
    THETA_DIM,
    Adversary,
    AdvCtx,
    AdvState,
    adversary_bank,
    apply_accuse_bank,
    apply_adversary_bank,
    apply_message_adversary_bank,
    apply_sparse_message_adversary_bank,
    attack_names,
    bank_accuses,
    bank_engaged,
    bank_stateful,
    cell_theta,
    default_thetas,
    get_adversary,
    init_state,
    registry_tiers,
)

__all__ = [
    "ADVERSARIES", "THETA_DIM", "Adversary", "AdvCtx", "AdvState", "adversary_bank",
    "apply_accuse_bank", "apply_adversary_bank", "apply_message_adversary_bank",
    "apply_sparse_message_adversary_bank", "attack_names", "bank_accuses", "bank_engaged",
    "bank_stateful", "cell_theta", "default_thetas", "get_adversary", "init_state",
    "registry_tiers",
]
