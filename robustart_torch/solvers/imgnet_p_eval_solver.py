"""``imgnet_p_eval_solver`` — ImageNet-P perturbation videos and their mFR.

Counterpart of ``robustart_tpu/solvers/imgnet_p_eval_solver.py``: the same
CLI (plus ``--device``), config keys and result files. Each sample is a
video of F frames; the solver writes {'predictions': [F ints]} a video to
``<perturbation>/results.txt.all`` and :class:`ImageNetPEvaluator` turns
each file into a flip rate (the summary's mean is the mFR).

``data.test.perturbations`` (default :data:`DEFAULT_PERTURBATIONS`) and
``data.test.n_frames`` (default 31) choose the videos. Three modes:

- **online** (``data.test.imagenet_p_online``): the clean val batch goes to
  the device once and each frame is made there by :func:`perturb_frame`,
  one call for the whole batch: then the uint8 grid, the forward and the
  argmax on the device into an (F, B) buffer, fetched once a batch. The
  six warping perturbations run K2 (``ops/warp.py``) once a frame, snow K3
  (``ops/motion.py``), the model its own kernels.
- **fake videos** (``read_from: fake`` without the online flag): frame k is
  the clean image plus k times a drift drawn from numpy's generator 17, on
  the host; one forward over the B·F frames.
- **stored** (otherwise): ``root_dir/<perturbation>/`` holds the videos as
  ``.npy`` (F, H, W, 3) arrays or video files (``data/dataset.py``); one
  forward over the B·F frames.

A result file that exists is kept (recovery by the filesystem).
"""

from __future__ import annotations

import math
import os.path as osp
import time
import zlib

import numpy as np
import torch

from robustart_torch.core.logging import get_logger
from robustart_torch.data import build_dataloader
from robustart_torch.metrics import ImageNetPEvaluator
from robustart_torch.noise.corruptions import CORRUPTIONS, to_unit, uint8_roundtrip
from robustart_torch.ops.image import fma
from robustart_torch.ops.warp import warp_bilinear
from robustart_torch.solvers.base import ResultWriter, Solver, standard_solver_argparser

logger = get_logger("robustart.p_eval")

DEFAULT_PERTURBATIONS = (
    "gaussian_noise", "shot_noise", "motion_blur", "zoom_blur",
    "brightness", "translate", "rotate", "tilt", "scale", "snow",
)
# an independent draw each frame, at a severity that ramps with the frame
NOISE_PERTURBATIONS = ("gaussian_noise", "shot_noise", "speckle_noise", "snow")


def is_warp(pert: str) -> bool:
    """Whether ``pert``'s frames are K2 warps (:func:`affine_coords`): every
    name but the noise perturbations and brightness."""
    return pert not in NOISE_PERTURBATIONS and pert != "brightness"


def frame_severity(frame: int, n_frames: int) -> int:
    """A noise perturbation's severity at ``frame``: ``min(1 + 5f // F, 5)``,
    so frame 0 is severity 1, not the clean image (the JAX package's
    formula, which its docstring contradicts)."""
    return min(1 + (frame * 5) // n_frames, 5)


def frame_constant(n_frames: int, *consts: float) -> np.float32:
    """``(1 / (n_frames − 1)) · c₁ · c₂ ⋯`` folded in float32, in order: the
    one constant the jitted JAX program multiplies the frame by, where
    ``t = frame / (n_frames − 1)`` (a division by a constant is a product
    by its float32 reciprocal) enters a chain of constant factors."""
    c = np.float32(1.0 / max(n_frames - 1, 1))
    for k in consts:
        c = np.float32(c * np.float32(k))
    return c


def frame_scale(frame: int, n_frames: int, *consts: float) -> np.float32:
    """``t · c₁ · c₂ ⋯`` of ``frame`` in float32 (:func:`frame_constant`)."""
    return np.float32(np.float32(frame) * frame_constant(n_frames, *consts))


def _fma32(a, b, c) -> np.float32:
    """``a·b + c`` rounded once to float32 (the JAX program's contraction)."""
    return np.float32(float(np.float32(a)) * float(np.float32(b)) + float(np.float32(c)))


def affine_coords(pert: str, frame: int, n_frames: int, h: int, w: int,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """The sample coordinates (H, W) float32 of a warping perturbation's
    frame, the same for every image: zoom_blur and scale a zoom by
    1 + 0.3t about the centre, rotate by 15t degrees, translate by
    (0.1H, 0.1W)·t, tilt a shear 0.2t, motion_blur a drift of 3t columns;
    any other name the identity. Scalars are made on the host in float32
    (:func:`frame_scale`, the cosine and sine rounded from float64), then
    one IEEE float32 step at a time on ``device``, where the JAX program
    contracts a product and a sum into one rounding (``ops/image.py::fma``)."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    if pert in ("zoom_blur", "scale"):
        z = float(_fma32(frame, frame_constant(n_frames, 0.3), 1.0))
        return (yy - cy) / z + cy, (xx - cx) / z + cx
    if pert == "rotate":
        ang = float(frame_scale(frame, n_frames, 15.0, math.pi, 1.0 / 180.0))
        c, s = float(np.float32(math.cos(ang))), float(np.float32(math.sin(ang)))
        dy, dx = yy - cy, xx - cx
        return fma(dy, c, cy) - dx * s, fma(dy, s, cx) + dx * c
    if pert == "translate":
        return (yy - float(frame_scale(frame, n_frames, h * 0.1)),
                xx - float(frame_scale(frame, n_frames, w * 0.1)))
    if pert == "tilt":
        return yy + float(frame_scale(frame, n_frames, 0.2)) * (xx - cx), xx
    if pert == "motion_blur":
        return yy, xx - float(frame_scale(frame, n_frames, 3.0))
    return yy, xx


def perturb_frame(pert: str, x01: torch.Tensor, frame: int, n_frames: int, *,
                  generator: torch.Generator | None = None,
                  coords: tuple[torch.Tensor, torch.Tensor] | None = None,
                  **draws) -> torch.Tensor:
    """Frame ``frame`` of a batch (B, H, W, 3) of [0,1] float32 images under
    ``pert``, one severity or one ``t`` for the whole batch: a noise
    perturbation is its corruption at :func:`frame_severity`, drawn from
    ``generator`` (or the injected ``draws``: ``normal=``, ``uniform=``,
    ``angles=``); brightness adds 0.4t and clips; every other name is one
    K2 warp at :func:`affine_coords` (``coords`` if given: they depend only
    on the perturbation and the frame), the identity for names that have
    no warp of their own (gaussian_blur, spatter, …), as in the JAX package."""
    if pert in NOISE_PERTURBATIONS:
        return CORRUPTIONS[pert](x01, frame_severity(frame, n_frames), generator=generator,
                                 **draws)
    if pert == "brightness":
        return torch.clamp(x01 + float(frame_scale(frame, n_frames, 0.4)), 0.0, 1.0)
    b, h, w, _ = x01.shape
    sy, sx = coords if coords is not None else affine_coords(pert, frame, n_frames, h, w,
                                                             x01.device)
    # K2 takes contiguous (B, H, W) maps: the frame's map once per image
    return warp_bilinear(x01.contiguous(), sy.expand(b, h, w).contiguous(),
                         sx.expand(b, h, w).contiguous())


def video_seed(run_seed: int, pert: str, batch_index: int) -> int:
    """The 32-bit seed of one (perturbation, batch) of a run, a stable hash
    (the JAX package keys on ``hash(pert)``, which changes every process)."""
    return zlib.crc32(f"{run_seed}/{pert}/{batch_index}".encode())


class ImgnetPEvalSolver(Solver):
    def evaluate(self, ckpt_path: str | None = None) -> dict:
        cfg = self.cfg
        if self.classifier is None:
            self.build_model(seed=int(cfg.get("seed", 0)))
        if ckpt_path:
            self.load_weights(ckpt_path)
        self.maybe_deploy()
        test_cfg = cfg.data.get("test", {})
        out_root = cfg.get_path("saver.results_dir", "results/imagenet-p")
        perturbations = list(test_cfg.get("perturbations", DEFAULT_PERTURBATIONS))
        n_frames = int(test_cfg.get("n_frames", 31))
        limit = test_cfg.get("limit_samples")

        evaluator = ImageNetPEvaluator()
        for pert in perturbations:
            res_file = osp.join(out_root, pert, "results.txt.all")
            if not osp.exists(res_file):
                self._eval_perturbation(pert, n_frames, res_file, limit)
            if self.rank == 0:
                out = evaluator.eval(res_file, perturbation=pert)
                logger.info("ImageNet-P %s: %s", pert, out)
        if self.rank != 0:
            return {}
        summary = {"per_perturbation": dict(evaluator.metric.metric), **evaluator.get_mean()}
        logger.info("ImageNet-P mFR summary: %s", summary)
        return summary

    @torch.inference_mode()
    def predict(self, x01: torch.Tensor) -> torch.Tensor:
        """Argmax classes of [0,1] NHWC images on the uint8 grid (the JAX
        program's ``u8 / 255``: :func:`to_unit`, :func:`uint8_roundtrip`),
        on their device."""
        return self.classifier(x01).argmax(-1)

    def _eval_perturbation(self, pert, n_frames, res_file, limit):
        cfg = self.cfg
        writer = ResultWriter(res_file, self.rank, self.world_size)
        if cfg.get_path("data.test.imagenet_p_online"):
            videos = self._online_videos(pert, n_frames)
        elif cfg.data.get("read_from", "fs") == "fake":
            videos = self._fake_videos(n_frames)
        else:
            videos = self._stored_videos(pert)
        n_done = 0
        n_frames_done = 0
        t0 = time.time()
        for preds, mask in videos:
            for i in range(preds.shape[0]):
                if mask[i]:
                    writer.write({"predictions": preds[i].tolist()})
                    n_done += 1
                    n_frames_done += preds.shape[1]
                    if limit and n_done >= limit:
                        break
            if limit and n_done >= limit:
                break
        dt = time.time() - t0
        logger.info("%s: %d videos, %d img-frames in %.2fs (%.1f img-frames/s)", pert, n_done,
                    n_frames_done, dt, n_frames_done / max(dt, 1e-9))
        writer.merge()

    def _loader(self, split_cfg_override=None):
        return build_dataloader(self.cfg.data, "test", self.rank, self.world_size,
                                split_cfg_override=split_cfg_override,
                                seed=int(self.cfg.get("seed", 0)))

    @torch.inference_mode()
    def _online_videos(self, pert, n_frames):
        """Storage-free ImageNet-P: each clean batch's video made on the
        device, frame by frame; yields ((B, F) int32 predictions, mask).
        Batch ``bi`` draws from ``video_seed(seed, pert, bi)``."""
        seed = int(self.cfg.get("seed", 0))
        coords = {}
        for bi, batch in enumerate(self._loader()):
            images = torch.from_numpy(batch.image).to(self.device)
            x01 = to_unit(images)
            b, h, w, _ = x01.shape
            gen = torch.Generator(device=self.device).manual_seed(video_seed(seed, pert, bi))
            preds = torch.empty((n_frames, b), dtype=torch.int32, device=self.device)
            for f in range(n_frames):
                if is_warp(pert) and f not in coords:
                    coords[f] = affine_coords(pert, f, n_frames, h, w, self.device)
                frame = perturb_frame(pert, x01, f, n_frames, generator=gen,
                                      coords=coords.get(f))
                preds[f] = self.predict(uint8_roundtrip(frame))
            yield preds.T.cpu().numpy(), batch.mask

    def _fake_videos(self, n_frames):
        """Videos from the fake backend, made on the host: frame k = clean
        frame + k · drift (numpy generator 17, a monotone drift that moves
        the flip metric); one forward over the B·F frames."""
        rng = np.random.default_rng(17)
        for batch in self._loader():
            imgs = batch.image.astype(np.float32)
            b = imgs.shape[0]
            drift = rng.normal(0, 4.0, size=imgs.shape).astype(np.float32)
            frames = np.stack([np.clip(imgs + k * drift, 0, 255) for k in range(n_frames)],
                              axis=1).astype(np.uint8)
            yield self._flat_predictions(frames), batch.mask

    def _stored_videos(self, pert):
        """Stored videos (F, H, W, 3) under ``root_dir/<pert>/``."""
        override = dict(self.cfg.data.get("test", {}))
        override["root_dir"] = osp.join(override.get("root_dir", ""), pert)
        for batch in self._loader(override):
            yield self._flat_predictions(batch.image), batch.mask

    def _flat_predictions(self, videos_u8: np.ndarray) -> np.ndarray:
        """(B, F) predictions of (B, F, H, W, 3) uint8 videos: one copy to
        the device, one forward over the B·F frames, one copy back."""
        b, f = videos_u8.shape[:2]
        flat = torch.from_numpy(np.ascontiguousarray(videos_u8)).to(self.device)
        x01 = to_unit(flat.reshape((b * f,) + flat.shape[2:]))
        return self.predict(x01).reshape(b, f).cpu().numpy()


def main(argv=None):
    parser = standard_solver_argparser("robustart imgnet_p_eval_solver")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    solver = ImgnetPEvalSolver(args.config, evaluate_only=True, device=args.device)
    return solver.evaluate(ckpt_path=args.ckpt_filePath)


if __name__ == "__main__":
    main()
