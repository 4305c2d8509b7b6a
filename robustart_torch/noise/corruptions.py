"""ImageNet-C corruptions in plain PyTorch: the noise family.

Counterpart of ``robustart_tpu/noise/corruptions/jax_kernels.py`` (:155-230)
and of ``corrupt_batch`` / ``CORRUPTION_ORDER`` in
``robustart_tpu/noise/corruptions/__init__.py``. Each corruption maps a
[0,1] float tensor to a [0,1] float tensor with the severity tables of the
JAX package. The random draw comes from ``generator``, or is injected with
``normal=`` / ``uniform=`` (the tests hand in the JAX package's draw).

``shot_noise`` is the exact Poisson sampler (CDF inversion unrolled to
``kmax``), which the ImageNet-C solver uses; the fused kernel's
``shot_noise`` mode is a Gaussian approximation of it. The blur, weather and
digital corruptions port with kernels K2-K5 (ROADMAP.md, modules to port,
item 6).
"""

from __future__ import annotations

import math

import torch

CORRUPTION_ORDER = (
    "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur",
    "glass_blur", "motion_blur", "zoom_blur", "snow", "frost", "fog",
    "brightness", "contrast", "elastic_transform", "pixelate",
    "jpeg_compression", "speckle_noise", "gaussian_blur", "spatter",
    "saturate",
)

# the per-severity parameter c of each noise corruption (jax_kernels.py)
NOISE_SEVERITY = {
    "gaussian_noise": (0.08, 0.12, 0.18, 0.26, 0.38),
    "shot_noise": (60.0, 25.0, 12.0, 5.0, 3.0),
    "impulse_noise": (0.03, 0.06, 0.09, 0.17, 0.27),
    "speckle_noise": (0.15, 0.2, 0.35, 0.45, 0.6),
}


def _draw_normal(x, generator, normal):
    if normal is not None:
        return torch.as_tensor(normal, dtype=x.dtype, device=x.device)
    return torch.randn(x.shape, dtype=x.dtype, device=x.device, generator=generator)


def _draw_uniform(x, generator, uniform, dtype=None):
    dtype = dtype or x.dtype
    if uniform is not None:
        return torch.as_tensor(uniform, dtype=dtype, device=x.device)
    return torch.rand(x.shape, dtype=dtype, device=x.device, generator=generator)


def uint8_roundtrip(x01: torch.Tensor) -> torch.Tensor:
    """Quantize through the uint8 grid by truncation, as the reference's
    np.uint8 casts do."""
    return torch.floor(torch.clamp(x01, 0.0, 1.0) * 255.0) / 255.0


def gaussian_noise(x, severity=1, *, generator=None, normal=None):
    c = NOISE_SEVERITY["gaussian_noise"][severity - 1]
    return torch.clamp(x + c * _draw_normal(x, generator, normal), 0.0, 1.0)


def poisson_inverse_cdf(lam: torch.Tensor, kmax: int, u: torch.Tensor) -> torch.Tensor:
    """Poisson via CDF inversion: X = min{k : U < CDF_k(lam)}, exact for the
    bounded rate here (lam ≤ c), unrolled to ``kmax`` terms."""
    p = torch.exp(-lam)
    cdf = p
    n = torch.zeros_like(lam)
    for k in range(kmax):
        n = n + (u >= cdf).to(torch.float32)
        p = p * (lam * (1.0 / (k + 1.0)))
        cdf = cdf + p
    return n


def shot_noise(x, severity=1, *, generator=None, uniform=None):
    c = NOISE_SEVERITY["shot_noise"][severity - 1]
    kmax = int(c + 12.0 * math.sqrt(c) + 12.0)
    u = _draw_uniform(x, generator, uniform, torch.float32)
    n = poisson_inverse_cdf(x.to(torch.float32) * c, kmax, u)
    return torch.clamp(n.to(x.dtype) / c, 0.0, 1.0)


def impulse_noise(x, severity=1, *, generator=None, uniform=None):
    # skimage random_noise(mode='s&p', amount=c): elementwise salt (1.0) or
    # pepper (0.0) with probability c/2 each
    c = NOISE_SEVERITY["impulse_noise"][severity - 1]
    u = _draw_uniform(x, generator, uniform)
    x = torch.where(u < c / 2, 0.0, x)
    x = torch.where(u > 1.0 - c / 2, 1.0, x)
    return torch.clamp(x, 0.0, 1.0)


def speckle_noise(x, severity=1, *, generator=None, normal=None):
    c = NOISE_SEVERITY["speckle_noise"][severity - 1]
    return torch.clamp(x + x * c * _draw_normal(x, generator, normal), 0.0, 1.0)


CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "speckle_noise": speckle_noise,
}


def not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"corruption {name!r} is not ported yet: the blur, weather and "
        "digital corruptions port with kernels K2-K5 (ROADMAP.md, modules "
        "to port, item 6)"
    )


def corrupt_batch(x: torch.Tensor, name: str, severity: int = 1, *,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Apply one corruption to a batch (B, H, W, 3) of [0,1] images."""
    if name not in CORRUPTIONS:
        if name in CORRUPTION_ORDER:
            raise not_ported(name)
        raise ValueError(f"unknown corruption {name!r}")
    return CORRUPTIONS[name](x, severity, generator=generator)
