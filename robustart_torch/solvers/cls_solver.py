"""``cls_solver``: classification training and evaluation.

Counterpart of ``robustart_tpu/solvers/cls_solver.py``. One YAML config
drives training and evaluation (``--evaluate``), with ``--recover`` and
``--ckpt-filePath``.

Training (:meth:`ClsSolver.train`; ResNet-family and ViT/DeiT models) runs
one step a batch on the device, in the JAX step's order
(``cls_solver.py:166-236``): the uint8 batch to the device, /255 as the
jitted JAX step computes it (``div_const``), the in-step attack when
``adv_train.enable`` (the model in eval mode: running BatchNorm statistics
and the current weights; its backward reaches the image only), mixup/cutmix
(``solvers/optim.py``), the classifier's normalization and the model in
train mode (Flax's BatchNorm; ViT's K6/K7 at zero rates), label-smoothed
cross-entropy, the backward, the optimizer's update and the EMA. Float32
master parameters, BatchNorm statistics and optimizer state under
``model.dtype: bf16``. Each step draws from its own ``torch.Generator`` on
the device, seeded by (``seed``, step). Around the step: ``saver.print_freq``
(a ``train_history.jsonl`` line with the JAX package's keys),
``saver.val_freq`` and each epoch's end write a checkpoint
(``solvers/checkpointing.py``), ``lr_scheduler.kwargs.max_iter`` stops
mid-epoch. ``--recover`` takes the port's own checkpoint (the whole state),
a JAX msgpack checkpoint (``extra.state``: parameters, BatchNorm
statistics, EMA, the optimizer's moments through the weight bridge, step
and epoch) or a foreign torch checkpoint (weights only, a fresh optimizer).

Evaluation: the ONECROP test loader, ``data.test.limit_samples``,
``maybe_quantize`` (which gives a RepVGG its deploy form), one
``results.txt.all`` and ``ImageNetEvaluator`` (or ``ImageNetCEvaluator``
under ``data.test.evaluator.type: imagenetc``). ``--ckpt-filePath`` loads a
checkpoint (a file, or the newest in a directory: JAX msgpack first),
with ``model.use_ema`` (auto, true, false) choosing the EMA weights of a
training checkpoint; after training the evaluation takes the EMA weights
unless ``model.use_ema: false``. ``main`` with ``--evaluate`` over a
config's ``eval_list`` evaluates each entry with its own solver, the model
at its own input size (``core/config.py::iter_eval_list``):

    python -m robustart_torch.solvers.cls_solver --config config.yaml [--evaluate] [--device cpu]
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time

import numpy as np
import torch

from robustart_torch.attacks.gradient import ATTACKS
from robustart_torch.core.config import Config, iter_eval_list, load_config
from robustart_torch.core.logging import get_logger
from robustart_torch.data import build_dataloader
from robustart_torch.metrics import ImageNetCEvaluator, ImageNetEvaluator
from robustart_torch.models.convert import load_pretrain, read_torch_checkpoint
from robustart_torch.models.convert import state_dict_from_flax_tree
from robustart_torch.models.classifier import StepAttackView
from robustart_torch.models.layers import full_f32, normalize_jit
from robustart_torch.ops.image import div_const
from robustart_torch.solvers.base import (TORCH_CKPT_EXTS, ResultWriter, Solver,
                                          load_eval_variables, newest_checkpoint,
                                          standard_solver_argparser)
from robustart_torch.solvers.checkpointing import load_any, save_train_checkpoint
from robustart_torch.solvers.optim import (apply_mix, build_optimizer, build_schedule, draw_mix,
                                           ema_update, one_hot_smooth, smoothed_cross_entropy)

logger = get_logger("robustart.cls_solver")

# the model families whose train mode is ported
TRAINABLE = ("ResNet", "VisionTransformer")


def _opt_moments(tree: dict, out: dict) -> dict:
    """The param-shaped moment trees (``trace``, ``mu``, ``nu``) and the
    update count of an optax state as the JAX package's msgpack holds it."""
    for k, v in tree.items():
        if k in ("trace", "mu", "nu") and isinstance(v, dict):
            out[k] = v
        elif k == "count":
            out.setdefault("count", int(np.asarray(v)))
        elif isinstance(v, dict):
            _opt_moments(v, out)
    return out


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The generator of one training step: the attack's start and the
    mixup/cutmix draws."""
    return torch.Generator(device=device).manual_seed((seed + 1) * 1_000_003 + step)


class ClsSolver(Solver):
    """Training and evaluation solver for image classification."""

    # ------------------------------------------------------------------ train
    def train(self, recover: str | None = None) -> None:
        cfg = self.cfg
        seed = int(cfg.get("seed", 0))
        plan = self.prepare_train(recover)
        loader0, max_epoch, max_iter = plan["loader"], plan["max_epoch"], plan["max_iter"]
        steps_per_epoch = len(loader0)
        start_epoch = plan["start_epoch"]
        model = self.classifier.model

        saver = cfg.get("saver") or {}
        print_freq = int(saver.get("print_freq", 10))
        val_freq = int(saver.get("val_freq", steps_per_epoch))
        save_many = bool(saver.get("save_many", False))
        save_dir = saver.get("save_dir", "checkpoints")
        os.makedirs(save_dir, exist_ok=True)
        history = open(osp.join(save_dir, "train_history.jsonl"), "a")
        stop = False
        try:
            for epoch in range(start_epoch, max_epoch):
                loader = loader0 if epoch == 0 else build_dataloader(
                    cfg.data, "train", self.rank, self.world_size, epoch=epoch, seed=seed)
                t0 = time.time()
                for batch in loader:
                    metrics = self.train_step(batch.image, batch.label)
                    if self.step % print_freq == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        logger.info("epoch %d step %d loss %.4f acc %.3f lr %.5f (%.1f img/s)",
                                    epoch, self.step, m["loss"], m["acc"], m["lr"],
                                    print_freq * len(batch.image) / max(time.time() - t0, 1e-9))
                        history.write(json.dumps({"step": self.step, "epoch": epoch, **m,
                                                  "time": time.time()}) + "\n")
                        history.flush()
                        t0 = time.time()
                    if self.step % val_freq == 0:
                        self.save_train_checkpoint(save_dir, epoch, save_many)
                    if max_iter and self.step >= max_iter:
                        stop = True
                        break
                self.save_train_checkpoint(save_dir, epoch + 1, save_many)
                if stop:
                    break
        finally:
            history.close()
        model.eval()

    def prepare_train(self, recover: str | None = None) -> dict:
        """Build the model (float32 master parameters), the schedule, the
        optimizer and its state, the EMA and the first epoch's loader, then
        load ``recover``. Returns the loader, the epoch to start from, and
        the run's ``max_epoch`` and ``max_iter`` (0: none)."""
        cfg = self.cfg
        seed = int(cfg.get("seed", 0))
        model = self.build_model(seed=seed).model
        family = type(model).__name__
        if family not in TRAINABLE:
            raise NotImplementedError(
                f"training {family} is not ported (ROADMAP.md, modules to port: Training)")
        if self.int8:
            raise ValueError("model.quantize: int8 is an eval path; train without it")
        if bool((cfg.get("lms") or {}).get("enable", False)):
            raise NotImplementedError("lms (rematerialization) is not ported (ROADMAP.md, "
                                      "modules to port: Training)")
        model.float()  # float32 masters; the forward still computes in model.dtype
        lr_kwargs = cfg.lr_scheduler.get("kwargs") or {}
        max_epoch = int(lr_kwargs.get("max_epoch", 100))
        loader = build_dataloader(cfg.data, "train", self.rank, self.world_size, epoch=0,
                                  seed=seed)
        steps_per_epoch = len(loader)
        max_iter = 0
        if "max_epoch" not in lr_kwargs and "max_iter" in lr_kwargs:
            # iteration-budgeted recipes stop at exactly max_iter steps
            max_iter = int(lr_kwargs["max_iter"])
            max_epoch = max(-(-max_iter // max(steps_per_epoch, 1)), 1)
        self.schedule = build_schedule(cfg.lr_scheduler, steps_per_epoch)
        self.optimizer = build_optimizer(cfg.optimizer, self.schedule, model)
        self.params = dict(model.named_parameters())
        ema_cfg = cfg.get("ema") or {}
        self.ema_decay = (float((ema_cfg.get("kwargs") or {}).get("decay", 0.9999))
                          if ema_cfg.get("enable", False) else None)
        self.opt_state = self.optimizer.init(self.params)
        self.ema = self._fresh_ema()
        self.step = 0
        start_epoch = self._recover(recover) if recover else 0
        return {"loader": loader, "start_epoch": start_epoch, "max_epoch": max_epoch,
                "max_iter": max_iter}

    def _fresh_ema(self) -> dict[str, torch.Tensor]:
        if self.ema_decay is None:
            return {}
        return {n: p.detach().clone() for n, p in self.params.items()}

    def train_step(self, images_u8: np.ndarray, labels: np.ndarray) -> dict[str, torch.Tensor]:
        """One training step on a uint8 NHWC host batch; returns the loss,
        the batch accuracy and the lr as device scalars (no host sync)."""
        cfg = self.cfg
        clf, model, device = self.classifier, self.classifier.model, self.device
        mixup_alpha = float(cfg.get("mixup", 0.0) or 0.0)
        cutmix_alpha = float(cfg.get("cutmix", 0.0) or 0.0)
        gen = step_generator(device, int(cfg.get("seed", 0)), self.step)
        levels = torch.from_numpy(images_u8).to(device).to(torch.float32)
        x = div_const(levels, 255.0)
        y = torch.from_numpy(np.asarray(labels)).to(device).long()
        soft = one_hot_smooth(y, clf.num_classes, float(cfg.get("label_smooth", 0.0) or 0.0))
        adv_cfg = cfg.get("adv_train") or {}
        if adv_cfg.get("enable", False):
            model.eval()
            try:
                attack = ATTACKS[adv_cfg.get("attack", "pgd_linf")]
                x = attack(StepAttackView(clf), x, y, gen,
                           **dict(adv_cfg.get("kwargs") or {})).detach()
                levels = None
            finally:
                # the attack freezes the model: its gradient is the image's alone
                for p in self.params.values():
                    p.requires_grad_(True)
        draws = draw_mix(gen, x.shape[0], x.shape[1], x.shape[2], mixup_alpha, cutmix_alpha)
        x, soft = apply_mix(x, soft, draws, mixup_alpha, cutmix_alpha, levels=levels,
                            finish=lambda im, lv: normalize_jit(im, clf.mean, clf.std, lv))
        with torch.enable_grad(), full_f32():
            logits = clf.forward_train(x)
            loss = smoothed_cross_entropy(logits, soft)
            names = list(self.params)
            grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                        allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(self.params[n]))
                 for n, g in zip(names, grads)}
        lr = self.optimizer.step(self.params, grads, self.opt_state)
        if self.ema:
            ema_update(self.ema, self.params, self.ema_decay)
        self.step += 1
        acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        return {"loss": loss.detach(), "acc": acc, "lr": torch.tensor(lr)}

    # ------------------------------------------------------------ checkpoints
    def train_payload(self, epoch: int) -> dict:
        """The port's training checkpoint (``solvers/checkpointing.py``)."""
        cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
        opt = {k: (cpu(v) if isinstance(v, dict) else v) for k, v in self.opt_state.items()}
        return {"model": cpu(self.classifier.model.state_dict()), "ema": cpu(self.ema),
                "optimizer": opt, "epoch": epoch, "step": self.step}

    def save_train_checkpoint(self, save_dir: str, epoch: int, save_many: bool) -> str:
        name = f"ckpt_e{epoch}.pth.tar" if save_many else "ckpt.pth.tar"
        path = osp.join(save_dir, name)
        save_train_checkpoint(path, self.train_payload(epoch))
        return path

    @torch.no_grad()
    def _load_state(self, weights: dict, ema: dict | None, moments: dict | None,
                    step: int) -> None:
        model = self.classifier.model
        missing = set(model.state_dict()) - set(weights)
        if missing:
            raise KeyError(f"checkpoint lacks {sorted(missing)[:5]}")
        model.load_state_dict({k: weights[k] for k in model.state_dict()})
        if self.ema_decay is not None:
            src = ema or {n: p for n, p in self.params.items()}
            self.ema = {n: src[n].to(self.device, torch.float32).clone() for n in self.params}
        self.step = step
        self.opt_state["count"] = step
        for key, tree in (moments or {}).items():
            if key == "count":
                if tree != step:
                    raise ValueError(f"optimizer count {tree} differs from step {step}")
                continue
            if key not in self.opt_state:
                raise ValueError(f"the checkpoint's optimizer has {key!r}; this one does not")
            for n, t in self.opt_state[key].items():
                t.copy_(tree[n])

    def _recover(self, path: str) -> int:
        """Load ``--recover``; returns the epoch to start from."""
        model = self.classifier.model
        if path.endswith(".msgpack"):
            st = load_any(path)["extra"]
            state = st["state"]
            weights = state_dict_from_flax_tree(
                {"params": state["params"], "batch_stats": state.get("batch_stats") or {}}, model)
            ema = (state_dict_from_flax_tree({"params": state["ema_params"]}, model)
                   if state.get("ema_params") else None)
            moments = _opt_moments(state.get("opt_state") or {}, {})
            moments = {k: (v if k == "count" else state_dict_from_flax_tree({"params": v}, model))
                       for k, v in moments.items()}
            self._load_state(weights, ema, moments, int(np.asarray(state["step"])))
            epoch = int(np.asarray(st.get("epoch", 0)))
            logger.info("recovered from JAX checkpoint %s at epoch %d", path, epoch)
            return epoch
        if not path.endswith(TORCH_CKPT_EXTS):
            load_any(path)  # refuses an Orbax directory
            raise ValueError(f"unrecognized checkpoint {path}")
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "optimizer" in obj and "model" in obj:
            opt = obj["optimizer"]
            self._load_state(obj["model"], obj.get("ema") or None, opt, int(obj["step"]))
            logger.info("recovered from %s at epoch %d", path, int(obj["epoch"]))
            return int(obj["epoch"])
        # a foreign torch checkpoint: the weights, a fresh optimizer and epoch
        with torch.no_grad():
            load_pretrain(model, read_torch_checkpoint(path))
        self.ema = self._fresh_ema()
        logger.info("recovered weights from torch checkpoint %s (fresh optimizer state)", path)
        return 0

    # ------------------------------------------------------------------- eval

    def evaluate(self, ckpt_path: str | None = None,
                 results_path: str | None = None) -> dict:
        cfg = self.cfg
        use_ema = cfg.get_path("model.use_ema")
        if self.classifier is None:
            self.build_model(seed=int(cfg.get("seed", 0)))
        model = self.classifier.model
        if ckpt_path:
            if osp.isdir(ckpt_path):
                ckpt_path = newest_checkpoint(ckpt_path)
            logger.info("loading checkpoint %s", ckpt_path)
            sd = load_eval_variables(ckpt_path, model, use_ema)
            with torch.no_grad():
                if ckpt_path.endswith(".msgpack"):
                    model.load_state_dict(sd)
                else:
                    load_pretrain(model, sd)
        elif use_ema is not False and getattr(self, "ema", None):
            # post-train eval on an EMA-trained run defaults to the EMA copy
            with torch.no_grad():
                for n, p in self.params.items():
                    p.copy_(self.ema[n])
            logger.info("eval: using EMA weights from the training run")
        model.eval()

        loader = build_dataloader(cfg.data, "test", self.rank, self.world_size,
                                  seed=int(cfg.get("seed", 0)))
        results_path = results_path or cfg.get_path("saver.results_path",
                                                    "results/results.txt.all")
        self.maybe_quantize(loader)
        writer = ResultWriter(results_path, self.rank, self.world_size)
        t0 = time.perf_counter()
        n = self.run_eval_loop(loader, writer,
                               limit_samples=cfg.get_path("data.test.limit_samples"))
        self.loop_stats = {"images": n, "seconds": time.perf_counter() - t0}
        merged = writer.merge()
        if self.rank != 0:
            return {}
        ev_cfg = cfg.get_path("data.test.evaluator") or Config(
            {"type": "imagenet", "kwargs": {"topk": [1, 5]}})
        kwargs = dict(ev_cfg.get("kwargs") or {})
        evaluator = (ImageNetCEvaluator(**kwargs) if ev_cfg.get("type", "imagenet") == "imagenetc"
                     else ImageNetEvaluator(**kwargs))
        metric = evaluator.eval(merged)
        logger.info("eval metric: %s", metric)
        return dict(metric.metric)


def eval_list_solvers(cfg: Config, device: str = "cuda"):
    """One :class:`ClsSolver` for each entry of the config's ``eval_list``,
    each writing ``results/eval_<i>/results.txt.all`` unless the entry names
    ``saver.results_path``."""
    for i, sub in enumerate(iter_eval_list(cfg)):
        sub["saver"] = sub.get("saver") or {}
        sub.saver.results_path = sub.get_path("saver.results_path",
                                              f"results/eval_{i}/results.txt.all")
        yield ClsSolver(sub, evaluate_only=True, device=device)


def main(argv=None):
    parser = standard_solver_argparser("robustart cls_solver")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if not args.evaluate:
        solver = ClsSolver(cfg, device=args.device)
        solver.train(recover=args.recover)
        return solver.evaluate()
    if cfg.get("eval_list"):
        # batch evaluation of many checkpoints from one config (reference
        # README.md:70-91, exprs/exp/swin/config.yaml:8-10)
        return [solver.evaluate(ckpt_path=args.ckpt_filePath)
                for solver in eval_list_solvers(cfg, args.device)]
    return ClsSolver(cfg, evaluate_only=True, device=args.device).evaluate(
        ckpt_path=args.ckpt_filePath)


if __name__ == "__main__":
    main()
