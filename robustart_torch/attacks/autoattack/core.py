"""AutoAttack: the parameter-free ensemble cascade.

Counterpart of ``robustart_tpu/attacks/autoattack/core.py``:
``AutoAttack(model, norm, eps, version).run_standard_evaluation(x, y, bs)``
with the versions

- standard: APGD-CE (1 restart) → APGD-T (9 target classes) → FAB-T (9
  targets) → Square (5,000 queries); in L1 APGD runs the 3ε → 2ε → ε
  schedule with 5 restarts and 5 target classes;
- rand: APGD-CE and APGD-DLR, each gradient the mean of 20 backwards (EOT);
- plus: APGD-CE, APGD-DLR, FAB, Square, APGD-T and FAB-T, 5 restarts.

``model`` maps NHWC images in [0, 1] (float32) to logits (a
``Classifier``). Each stage runs on the compacted worklist of the samples
still robust, in chunks of ``bs``, on x's device, and a stage's output is
accepted where it is misclassified, inside the 1.001·eps ball and finite.
The JAX package pads each chunk to ``bs`` so that XLA's shapes stay
fixed; every stage is per sample, so running the chunk unpadded changes
no output. The device's values reach the host only between stages,
chunks and target ranks.

Each ``run_standard_evaluation`` starts a generator from ``seed``: each
chunk takes a seed from it, and the stages' random draws come from
streams derived from the chunk's seed and the restart (``r``) or target
rank (``100 + rank``, ``200 + rank``), as the JAX package folds its key.
"""

from __future__ import annotations

import hashlib
import time

import torch

from robustart_torch.attacks.autoattack.apgd import apgd_attack, apgd_attack_largereps
from robustart_torch.attacks.autoattack.fab import fab_attack_targeted
from robustart_torch.attacks.autoattack.square import (
    square_attack_l1,
    square_attack_l2,
    square_attack_linf,
)
from robustart_torch.core.device import resolve_device
from robustart_torch.core.logging import get_logger
from robustart_torch.models.layers import full_f32

logger = get_logger("robustart.autoattack")

SQUARE = {"Linf": square_attack_linf, "L2": square_attack_l2, "L1": square_attack_l1}


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``data``."""
    digest = hashlib.blake2b(f"{seed}/{data}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class AutoAttack:
    def __init__(self, model, norm: str = "Linf", eps: float = 8 / 255,
                 version: str = "standard", verbose: bool = False, seed: int | None = None,
                 attacks_to_run: list[str] | None = None, n_iter: int = 100,
                 n_target_classes: int = 9, square_n_queries: int = 5000, mesh=None,
                 data_axis: str = "data", device="cuda"):
        if norm not in ("Linf", "L2", "L1"):
            raise ValueError(f"unknown norm {norm!r}")
        if mesh is not None or data_axis != "data":
            raise NotImplementedError(
                "AutoAttack over a device mesh is not ported yet (ROADMAP.md, modules to "
                "port: Facade, parallelism, CIFAR and tools)")
        self.model = model
        self.norm = norm
        self.eps = float(eps)
        self.version = version
        self.verbose = verbose
        self.seed = seed if seed is not None else 0
        self.n_iter = n_iter
        self.n_target_classes = n_target_classes
        self.square_n_queries = square_n_queries
        self.device = resolve_device(device)
        # each stage of the last run: (attack, seconds, robust accuracy in %)
        self.stages: list[tuple[str, float, float]] = []

        self.use_largereps = False
        self.apgd_n_restarts, self.eot_iter = 1, 1
        if attacks_to_run is not None:
            self.attacks_to_run = list(attacks_to_run)
        elif version == "standard":
            self.attacks_to_run = ["apgd-ce", "apgd-t", "fab-t", "square"]
            if norm == "L1":
                self.use_largereps = True
                self.apgd_n_restarts = 5
                self.n_target_classes = min(n_target_classes, 5)
        elif version == "rand":
            self.attacks_to_run = ["apgd-ce", "apgd-dlr"]
            self.eot_iter = 20
        elif version == "plus":
            self.attacks_to_run = ["apgd-ce", "apgd-dlr", "fab", "square", "apgd-t", "fab-t"]
            self.apgd_n_restarts = 5
        else:
            raise ValueError(f"unknown version {version!r}")

    # -- helpers --
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), full_f32():
            return self.model(x).float()

    def _predict(self, x: torch.Tensor) -> torch.Tensor:
        return self._logits(x).argmax(1)

    def _stream(self, seed: int, data: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(fold_in(seed, data))

    def _inputs(self, x, y) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(x, dtype=torch.float32, device=self.device),
                torch.as_tensor(y, device=self.device).long())

    def clean_accuracy(self, x, y, bs: int = 250) -> float:
        x, y = self._inputs(x, y)
        correct = sum(int((self._predict(x[lo:lo + bs]) == y[lo:lo + bs]).sum())
                      for lo in range(0, x.shape[0], bs))
        return correct / x.shape[0]

    def _ranked_targets(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(n_target_classes, n): at rank r, the (r + 1)-th most likely class
        other than the label, the last such class where fewer are left."""
        logits = self._logits(x)
        n_classes = logits.shape[1]
        order = torch.topk(logits, min(self.n_target_classes + 1, n_classes), dim=1).indices
        hit = order == y[:, None]
        pos_y = torch.where(hit.any(1), hit.int().argmax(1), order.shape[1])
        ranks = []
        for rank in range(self.n_target_classes):
            r = min(rank, n_classes - 2)
            ranks.append(torch.where(pos_y > r, order[:, r], order[:, r + 1]))
        return torch.stack(ranks)

    # -- cascade --
    def run_standard_evaluation(self, x, y, bs: int = 250,
                                attacks_to_run: list[str] | None = None) -> torch.Tensor:
        """The adversarial images of ``x`` (N, H, W, 3) in [0, 1] at labels
        ``y``, on this attack's device: each sample the first stage's
        accepted output, or x where it stayed robust."""
        attacks = self.attacks_to_run if attacks_to_run is None else attacks_to_run
        x, y = self._inputs(x, y)
        n = x.shape[0]
        x_adv = x.clone()
        t_start = time.time()
        robust = torch.cat([self._predict(x[lo:lo + bs]) == y[lo:lo + bs]
                            for lo in range(0, n, bs)])
        if self.verbose:
            logger.info("initial accuracy: %.2f%%", 100 * float(robust.float().mean()))

        run = torch.Generator().manual_seed(self.seed)
        self.stages = []
        for attack in attacks:
            idx_robust = torch.nonzero(robust)[:, 0]
            if len(idx_robust) == 0:
                break
            t0 = time.time()
            for lo in range(0, len(idx_robust), bs):
                sel = idx_robust[lo:lo + bs]
                seed = int(torch.randint(2**62, (), generator=run))
                x_try = self._run_one(attack, x[sel], y[sel], seed)
                newly_broken = self._predict(x_try) != y[sel]
                delta = (x_try - x[sel]).flatten(1).double()
                if self.norm == "Linf":
                    norms = delta.abs().amax(1)
                elif self.norm == "L1":
                    norms = delta.abs().sum(1)
                else:
                    norms = torch.sqrt((delta**2).sum(1))
                ok = (norms <= self.eps * 1.001) & torch.isfinite(x_try.flatten(1)).all(1)
                accept = newly_broken & ok
                x_adv[sel[accept]] = x_try[accept]
                robust[sel[accept]] = False
            acc = 100 * float(robust.float().mean())
            self.stages.append((attack, time.time() - t0, acc))
            if self.verbose:
                logger.info("%s done in %.1fs: robust accuracy %.2f%%", attack,
                            time.time() - t0, acc)
        if self.verbose:
            logger.info("AutoAttack (%s) finished in %.1fs: robust accuracy %.2f%%",
                        self.version, time.time() - t_start, 100 * float(robust.float().mean()))
        return x_adv

    def run_standard_evaluation_individual(self, x, y, bs: int = 250) -> dict:
        """Each attack's adversarial set on its own. Reentrant: it does not
        change ``attacks_to_run``."""
        return {attack: self.run_standard_evaluation(x, y, bs=bs, attacks_to_run=[attack])
                for attack in self.attacks_to_run}

    def _apgd(self, x, y, gen, *, loss, targets=None):
        kw = dict(eps=self.eps, loss=loss, n_iter=self.n_iter, targets=targets,
                  eot_iter=self.eot_iter)
        if self.use_largereps and self.norm == "L1":
            return apgd_attack_largereps(self.model, x, y, gen, **kw)
        return apgd_attack(self.model, x, y, gen, norm=self.norm, **kw)

    def _run_one(self, attack: str, x: torch.Tensor, y: torch.Tensor, seed: int) -> torch.Tensor:
        if attack == "apgd-ce":
            best = best_f = None
            for r in range(self.apgd_n_restarts):
                x_try, f = self._apgd(x, y, self._stream(seed, r), loss="ce")
                if best is None:
                    best, best_f = x_try, f
                else:
                    better = (f > best_f).reshape((-1,) + (1,) * (x.ndim - 1))
                    best = torch.where(better, x_try, best)
                    best_f = torch.maximum(f, best_f)
            return best
        if attack == "apgd-dlr":
            return apgd_attack(self.model, x, y, self._stream(seed, 0), eps=self.eps,
                               norm=self.norm, loss="dlr", n_iter=self.n_iter,
                               eot_iter=self.eot_iter)[0]
        if attack == "apgd-t":
            # each sample keeps the first target rank's success
            x_out = x.clone()
            fooled = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
            targets = self._ranked_targets(x, y)
            for rank in range(self.n_target_classes):
                x_try, _ = self._apgd(x, y, self._stream(seed, 100 + rank),
                                      loss="dlr-targeted", targets=targets[rank])
                new = (self._predict(x_try) != y) & ~fooled
                x_out[new] = x_try[new]
                fooled |= new
                if bool(fooled.all()):
                    break
            return x_out
        if attack == "fab":
            return fab_attack_targeted(self.model, x, y, None, eps=self.eps, norm=self.norm,
                                       n_iter=self.n_iter, untargeted=True)[0]
        if attack == "fab-t":
            # each sample keeps its least-norm success over the target ranks
            x_out = x.clone()
            best_norm = torch.full((x.shape[0],), torch.inf, device=x.device)
            targets = self._ranked_targets(x, y)
            for rank in range(self.n_target_classes):
                x_try, norms = fab_attack_targeted(self.model, x, y, targets[rank], eps=self.eps,
                                                   norm=self.norm, n_iter=self.n_iter)
                better = norms < best_norm
                x_out[better] = x_try[better]
                best_norm = torch.minimum(best_norm, norms)
            return x_out
        if attack == "square":
            return SQUARE[self.norm](self.model, x, y, self._stream(seed, 0), eps=self.eps,
                                     n_queries=self.square_n_queries)
        raise ValueError(f"unknown attack {attack!r}")
