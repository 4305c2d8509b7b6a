"""Adversarial attacks (counterpart of ``robustart_tpu.attacks``): the
gradient attacks here, AutoAttack in ``robustart_torch.attacks.autoattack``."""

from robustart_torch.attacks.gradient import (
    ATTACKS,
    attack_list,
    clip_l2_norm,
    fgsm,
    make_attack_fn,
    mim_linf,
    pgd_l1,
    pgd_l2,
    pgd_linf,
)

__all__ = [
    "ATTACKS",
    "attack_list",
    "clip_l2_norm",
    "fgsm",
    "pgd_linf",
    "pgd_l2",
    "pgd_l1",
    "mim_linf",
    "make_attack_fn",
]
