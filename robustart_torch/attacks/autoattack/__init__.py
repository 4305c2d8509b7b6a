"""AutoAttack: APGD-CE/T/DLR, FAB(-T) and Square in Linf, L2 and L1, and
the cascade of the versions standard, rand and plus (counterpart of
``robustart_tpu.attacks.autoattack``)."""

from robustart_torch.attacks.autoattack.apgd import (
    apgd_attack,
    apgd_attack_l1,
    apgd_attack_largereps,
    ce_loss_per_sample,
    dlr_loss,
    dlr_loss_targeted,
)
from robustart_torch.attacks.autoattack.core import AutoAttack
from robustart_torch.attacks.autoattack.fab import fab_attack_targeted
from robustart_torch.attacks.autoattack.square import (
    square_attack_l1,
    square_attack_l2,
    square_attack_linf,
)

__all__ = [
    "AutoAttack",
    "apgd_attack",
    "apgd_attack_l1",
    "apgd_attack_largereps",
    "fab_attack_targeted",
    "square_attack_linf",
    "square_attack_l2",
    "square_attack_l1",
    "ce_loss_per_sample",
    "dlr_loss",
    "dlr_loss_targeted",
]
