"""Attack utilities (counterpart of ``robustart_tpu/attacks/utils.py``, the
reference's ``Attacks/autoattack/other_utils.py``).

``Logger`` (file and stdout), per-sample L0/L1/L2/Linf norms, and
``check_imgs``: the audit the reference runs on an attack's output
(other_utils.py:15-28): the largest perturbation norm, the value range and
the count of values that are not finite. They take numpy arrays or tensors
(a tensor is copied to the host).
"""

from __future__ import annotations

import numpy as np
import torch

from robustart_torch.core.logging import get_logger


class Logger:
    """Minimal file and stdout logger (reference other_utils.py:4-13)."""

    def __init__(self, log_path: str | None = None):
        self.log_path = log_path

    def log(self, str_to_log: str) -> None:
        print(str_to_log)
        if self.log_path is not None:
            with open(self.log_path, "a") as f:
                f.write(str_to_log + "\n")
                f.flush()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(x) -> np.ndarray:
    x = _host(x)
    return x.reshape(len(x), -1)


def l0_norm(x) -> np.ndarray:
    return (_flat(x) != 0.0).sum(axis=1).astype(np.float64)


def l1_norm(x) -> np.ndarray:
    return np.abs(_flat(x)).sum(axis=1)


def l2_norm(x) -> np.ndarray:
    return np.sqrt((_flat(x) ** 2).sum(axis=1))


def linf_norm(x) -> np.ndarray:
    return np.abs(_flat(x)).max(axis=1)


_NORM_FNS = {"L0": l0_norm, "L1": l1_norm, "L2": l2_norm, "Linf": linf_norm}


def check_imgs(adv, x, norm: str = "Linf") -> tuple[float, float, float, int]:
    """(max_norm, min_value, max_value, n_nonfinite) of the perturbation
    ``adv - x`` and of ``adv``, logged."""
    adv, x = _host(adv), _host(x)
    res = float(_NORM_FNS[norm](adv - x).max())
    lo, hi = float(adv.min()), float(adv.max())
    bad = int((~np.isfinite(adv)).sum())
    get_logger(__name__).info(
        "check_imgs: max %s norm %.5f, range [%.5f, %.5f], non-finite %d",
        norm, res, lo, hi, bad,
    )
    return res, lo, hi, bad
