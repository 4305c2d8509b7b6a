"""Optimizers, LR schedules, EMA, mixup/cutmix and label smoothing.

Counterpart of ``robustart_tpu/solvers/optim.py``, with the reference
config vocabulary:

- ``optimizer{type ∈ {SGD, AdamW, Adam}, kwargs, no_wd}``: ``no_wd``
  exempts every parameter that is one-dimensional *in the JAX package*
  (biases, norm scales) from weight decay (:func:`no_wd_mask`);
- ``lr_scheduler{type ∈ {CosineEpoch, StepEpoch, Step}, kwargs}``;
- ``label_smooth``, ``mixup`` and ``cutmix`` (alphas), ``ema{enable,
  kwargs{decay}}``.

The optimizers are plain update functions over ``{name: tensor}`` dicts in
optax's order of operations (the JAX package's optimizers are optax's):
SGD is ``add_decayed_weights`` (masked) → ``trace`` (momentum, nesterov) →
``× −lr``; AdamW is ``scale_by_adam`` (``eps`` outside the square root) →
``add_decayed_weights`` (masked) → ``× −lr``; Adam has no decay. The lr of
update *t* (counted from 0) is ``schedule(t)``, as optax evaluates it
before the update; the schedules compute in float32 on the host, with each
division by a constant written as XLA compiles it in the JAX package's
jitted step (``ops/image.py::div_const``).

Mixup/cutmix is split in two: :func:`draw_mix` makes the step's draws on
the device from a ``torch.Generator`` (the permutation, the two Beta λ, the
switch, the box centre) and :func:`apply_mix` applies them with the JAX
function's arithmetic, so the tests can feed the JAX package's draws to
:func:`apply_mix`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from robustart_torch.models.convert import flax_ndim
from robustart_torch.ops.image import fma

Schedule = Callable[[int], float]
_f32 = np.float32


# -- LR schedules -------------------------------------------------------------


def _over(x, c) -> np.float32:
    """``x / c`` for a constant ``c``, as the jitted JAX step computes it:
    ``x · fl32(1/c)``."""
    return _f32(x) * _f32(1.0 / c)


def cosine_epoch_schedule(base_lr: float, warmup_lr: float, warmup_epoch: float,
                          max_epoch: float, min_lr: float, steps_per_epoch: int) -> Schedule:
    """Linear warmup base_lr→warmup_lr over warmup_epoch, cosine decay
    warmup_lr→min_lr until max_epoch (reference CosineEpoch)."""
    warmup_steps = max(int(warmup_epoch * steps_per_epoch), 1)
    total_steps = max(int(max_epoch * steps_per_epoch), warmup_steps + 1)

    def schedule(step: int) -> float:
        s = _f32(step)
        if s < warmup_steps:
            return float(_f32(base_lr) + _f32(warmup_lr - base_lr) * _over(s, warmup_steps))
        t = np.clip(_over(s - _f32(warmup_steps), total_steps - warmup_steps), _f32(0), _f32(1))
        cos = _f32(1) + np.cos(_f32(np.pi) * t)
        return float(_f32(min_lr) + _f32(0.5 * (warmup_lr - min_lr)) * cos)

    return schedule


def _step_decay(step: int, peak: float, boundaries, mults, base_lr: float,
                warmup_steps: int) -> float:
    s = _f32(step)
    lr = _f32(peak)
    for b, m in zip(boundaries, mults):
        if s >= b:
            lr = lr * _f32(m)
    if warmup_steps > 0 and s < warmup_steps:
        lr = _f32(base_lr) + _f32(peak - base_lr) * _over(s, warmup_steps)
    return float(lr)


def step_epoch_schedule(base_lr: float, lr_epochs, lr_mults, steps_per_epoch: int,
                        warmup_lr: float | None = None, warmup_epoch: float = 0.0) -> Schedule:
    """Piecewise-constant decay at epoch boundaries (reference StepEpoch)."""
    boundaries = [int(e * steps_per_epoch) for e in lr_epochs]
    peak = warmup_lr if warmup_lr is not None else base_lr
    warmup_steps = max(int(warmup_epoch * steps_per_epoch), 0)
    return lambda step: _step_decay(step, peak, boundaries, lr_mults, base_lr, warmup_steps)


def build_schedule(lr_cfg, steps_per_epoch: int) -> Schedule:
    kind = lr_cfg.get("type", "CosineEpoch")
    kw = dict(lr_cfg.get("kwargs") or {})
    if kind == "CosineEpoch":
        return cosine_epoch_schedule(
            base_lr=float(kw.get("base_lr", 0.1)),
            warmup_lr=float(kw.get("warmup_lr", kw.get("base_lr", 0.1))),
            warmup_epoch=float(kw.get("warmup_epoch", 0)),
            max_epoch=float(kw.get("max_epoch", 100)),
            min_lr=float(kw.get("min_lr", 0.0)),
            steps_per_epoch=steps_per_epoch)
    if kind == "StepEpoch":
        return step_epoch_schedule(
            base_lr=float(kw.get("base_lr", 0.1)),
            lr_epochs=list(kw.get("lr_epochs", [30, 60, 90])),
            lr_mults=list(kw.get("lr_mults", [0.1, 0.1, 0.1])),
            steps_per_epoch=steps_per_epoch,
            warmup_lr=kw.get("warmup_lr"),
            warmup_epoch=float(kw.get("warmup_epoch", 0)))
    if kind == "Step":
        # iteration-based: lr_steps/lr_mults + warmup_steps, stopped by max_iter
        boundaries = [int(s) for s in kw.get("lr_steps", [])]
        mults = list(kw.get("lr_mults", [0.1] * len(boundaries)))
        if len(mults) != len(boundaries):
            raise ValueError(f"lr_mults has {len(mults)} entries for {len(boundaries)} lr_steps")
        base_lr = float(kw.get("base_lr", 0.1))
        peak = float(kw.get("warmup_lr", base_lr))
        warmup_steps = int(kw.get("warmup_steps", 0))
        return lambda step: _step_decay(step, peak, boundaries, mults, base_lr, warmup_steps)
    raise ValueError(f"unknown lr_scheduler type {kind!r}")


# -- optimizers ---------------------------------------------------------------


def no_wd_mask(model: nn.Module) -> dict[str, bool]:
    """True = apply weight decay: the parameters whose JAX-package
    counterpart has more than one axis (the JAX ``_no_wd_mask``). The
    count comes from the weight bridge (``convert.flax_ndim``), not from the
    torch tensor, which has more axes for ConvNeXt-V2's GRN."""
    return {name: flax_ndim(name, p) > 1 for name, p in model.named_parameters()}


@dataclass
class Optimizer:
    """One of the reference's optimizers as update functions over
    ``{name: tensor}`` dicts. :meth:`init` makes the state (``count``, the
    number of updates so far, and ``trace`` or ``mu``/``nu``, shaped as the
    parameters); :meth:`step` applies one update in place and returns the
    lr it used."""

    kind: str
    schedule: Schedule
    momentum: float = 0.9
    nesterov: bool = False
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    decay_mask: Mapping[str, bool] | None = None

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def _decays(self, name: str) -> bool:
        return bool(self.weight_decay) and (self.decay_mask is None or self.decay_mask[name])

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state: dict) -> float:
        count = state["count"]
        lr = self.schedule(count)
        neg_lr = -lr
        if self.kind == "sgd":
            for n, p in params.items():
                g = grads[n]
                if self._decays(n):
                    g = g + self.weight_decay * p
                t = state["trace"][n]
                t.mul_(self.momentum).add_(g)  # g + m·t
                u = t * self.momentum + g if self.nesterov else t
                p.add_(u * neg_lr)
        else:
            b1, b2 = self.betas
            bc1 = _f32(1) - _f32(b1) ** _f32(count + 1)
            bc2 = _f32(1) - _f32(b2) ** _f32(count + 1)
            for n, p in params.items():
                g = grads[n]
                mu, nu = state["mu"][n], state["nu"][n]
                mu.mul_(b1).add_(g * (1 - b1))  # (1−b1)·g + b1·mu
                nu.mul_(b2).add_(g * g * (1 - b2))
                u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + self.eps)
                if self.kind == "adamw" and self._decays(n):
                    u = u + self.weight_decay * p
                p.add_(u * neg_lr)
        state["count"] = count + 1
        return lr


def build_optimizer(opt_cfg, schedule: Schedule, model: nn.Module) -> Optimizer:
    kind = (opt_cfg.get("type") or "SGD").lower()
    kw = dict(opt_cfg.get("kwargs") or {})
    wd = float(kw.pop("weight_decay", 0.0))
    mask = no_wd_mask(model) if bool(opt_cfg.get("no_wd", False)) else None
    betas = tuple(float(b) for b in kw.get("betas", [0.9, 0.999]))
    if kind == "sgd":
        return Optimizer("sgd", schedule, momentum=float(kw.get("momentum", 0.9)),
                         nesterov=bool(kw.get("nesterov", False)), weight_decay=wd,
                         decay_mask=mask)
    if kind == "adamw":
        return Optimizer("adamw", schedule, betas=betas, eps=float(kw.get("eps", 1e-8)),
                         weight_decay=wd, decay_mask=mask)
    if kind == "adam":
        # optax.adam takes no eps from the config: its default
        return Optimizer("adam", schedule, betas=betas)
    raise ValueError(f"unknown optimizer type {kind!r}")


# -- losses + batch augmentation ----------------------------------------------


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0) -> torch.Tensor:
    oh = F.one_hot(labels.long(), num_classes).to(torch.float32)
    if smoothing > 0:
        oh = oh * (1.0 - smoothing) + smoothing / num_classes
    return oh


def smoothed_cross_entropy(logits: torch.Tensor, soft_labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of −Σ soft·log_softmax(logits) (optax's
    ``softmax_cross_entropy``)."""
    return -(soft_labels * torch.log_softmax(logits.float(), dim=-1)).sum(-1).mean()


@dataclass
class MixDraws:
    """One step's mixup/cutmix draws: the permutation, the mixup and cutmix
    λ (0-d float32), the switch (True = mixup) and the box centre."""

    perm: torch.Tensor
    lam_mix: torch.Tensor
    lam_cut: torch.Tensor
    use_mix: torch.Tensor
    cy: torch.Tensor
    cx: torch.Tensor


def _log_gamma_sample(alpha: float, generator: torch.Generator, device, candidates: int = 16):
    """log of one Gamma(alpha, 1) draw, on the device (Marsaglia and Tsang,
    with the boost G(α) = G(α+1)·U^(1/α) below 1). ``candidates`` proposals
    are drawn at once and the first accepted one is taken; each is accepted
    with probability above 0.95, so all fail with probability below 1e-20."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    z = torch.randn(candidates, generator=generator, device=device, dtype=torch.float64)
    u = torch.rand(candidates, generator=generator, device=device, dtype=torch.float64)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v.clamp_min(1e-300)))
    first = torch.argmax(ok.to(torch.int8))
    log_g = torch.log(d * v.clamp_min(1e-300))[first]
    if alpha < 1.0:
        boost = torch.rand((), generator=generator, device=device, dtype=torch.float64)
        log_g = log_g + torch.log(boost.clamp_min(1e-300)) / alpha
    return log_g


def beta_sample(alpha: float, generator: torch.Generator, device) -> torch.Tensor:
    """One Beta(alpha, alpha) draw as a 0-d float32 tensor on the device,
    X/(X+Y) of two Gamma draws, formed from their logs."""
    lx = _log_gamma_sample(alpha, generator, device)
    ly = _log_gamma_sample(alpha, generator, device)
    return torch.sigmoid(lx - ly).to(torch.float32)


def draw_mix(generator: torch.Generator, batch: int, h: int, w: int, mixup_alpha: float,
             cutmix_alpha: float) -> MixDraws | None:
    """The step's draws for :func:`apply_mix` (None when both alphas are 0),
    all on the generator's device with no host synchronization."""
    if mixup_alpha <= 0 and cutmix_alpha <= 0:
        return None
    device = generator.device
    perm = torch.randperm(batch, generator=generator, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    lam_mix = beta_sample(mixup_alpha, generator, device) if mixup_alpha > 0 else one
    lam_cut = beta_sample(cutmix_alpha, generator, device) if cutmix_alpha > 0 else one
    use_mix = torch.rand((), generator=generator, device=device) < 0.5
    cy = torch.randint(0, h, (), generator=generator, device=device)
    cx = torch.randint(0, w, (), generator=generator, device=device)
    return MixDraws(perm, lam_mix, lam_cut, use_mix, cy, cx)


def apply_mix(images: torch.Tensor, soft_labels: torch.Tensor, draws: MixDraws | None,
              mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
              levels: torch.Tensor | None = None,
              finish: Callable[[torch.Tensor, torch.Tensor | None], torch.Tensor] | None = None):
    """Mixup or cutmix of NHWC [0, 1] images and their soft labels with the
    JAX function's arithmetic, as XLA compiles it on the CPU (every
    multiply-add fused, ``ops/image.py::fma``): mixup is
    ``fma(λ, x, (1−λ)·x_perm)``; cutmix pastes the permuted batch into the
    box of side ``int32(h·sqrt(1−λ))`` centred on the draw and clipped to the
    image, and weights the labels by ``fma(−area, fl32(1/(h·w)), 1)``; with
    both alphas set the switch picks one.

    ``levels`` (the uint8 levels the images are ``levels·fl32(1/255)`` of,
    or None) follow the cutmix paste, and ``finish(x, levels)``, where
    given, is applied to each branch's images before the switch (the
    training step's normalization, which XLA fuses into each branch:
    ``layers.normalize_jit``)."""
    finish = finish or (lambda x, lv: x)
    if draws is None or (mixup_alpha <= 0 and cutmix_alpha <= 0):
        return finish(images, levels), soft_labels
    images_p, labels_p = images[draws.perm], soft_labels[draws.perm]
    h, w = images.shape[1], images.shape[2]

    def mixup():
        lam = draws.lam_mix
        mixed = fma(images, lam.double(), ((1 - lam) * images_p).double())
        return finish(mixed, None), fma(soft_labels, lam.double(),
                                        ((1 - lam) * labels_p).double())

    def cutmix():
        ratio = torch.sqrt(1.0 - draws.lam_cut)
        cut_h = (h * ratio).to(torch.int32)
        cut_w = (w * ratio).to(torch.int32)
        y0 = torch.clamp(draws.cy - cut_h // 2, 0, h)
        y1 = torch.clamp(draws.cy + cut_h // 2, 0, h)
        x0 = torch.clamp(draws.cx - cut_w // 2, 0, w)
        x1 = torch.clamp(draws.cx + cut_w // 2, 0, w)
        yy = torch.arange(h, device=images.device)[None, :, None, None]
        xx = torch.arange(w, device=images.device)[None, None, :, None]
        box = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
        mixed = torch.where(box, images_p, images)
        cut_levels = None if levels is None else torch.where(box, levels[draws.perm], levels)
        area = ((y1 - y0) * (x1 - x0)).to(torch.float32)
        lam_adj = fma(area, -float(_f32(1.0 / (h * w))), 1.0)  # 1 − area/(h·w), one rounding
        return finish(mixed, cut_levels), fma(soft_labels, lam_adj.double(),
                                               ((1 - lam_adj) * labels_p).double())

    if mixup_alpha > 0 and cutmix_alpha > 0:
        img_m, lab_m = mixup()
        img_c, lab_c = cutmix()
        return (torch.where(draws.use_mix, img_m, img_c),
                torch.where(draws.use_mix, lab_m, lab_c))
    return mixup() if mixup_alpha > 0 else cutmix()


# -- EMA ----------------------------------------------------------------------


@torch.no_grad()
def ema_update(ema: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float) -> None:
    """``ema ← decay·ema + (1 − decay)·params``, in place."""
    for n, e in ema.items():
        e.mul_(decay).add_(params[n] * (1.0 - decay))
