"""The port's ImageNet-S (system noise) against the JAX package.

- ``decode_image`` for the pil, opencv and ffmpeg decoders in RGB, BGR and
  GRAY is bitwise the JAX package's on small Pillow-written JPEGs: 4:2:0 at
  an odd size, 4:4:4, 4:2:2, grayscale, progressive, and a 3 × 5 image whose
  chroma rows are short enough that libjpeg upsamples them plainly. Here
  the JAX package's ffmpeg axis is TensorFlow's INTEGER_FAST decode (no
  ffmpeg binary); the port's is its fast-IDCT route, which imports no
  TensorFlow. The route refuses CMYK and non-JPEG files, and it is not the
  accurate decode.
- ``ImageTransfer`` is bitwise over all 11 resize modes, val and train with a
  seed, online and through its offline ``.npy`` + meta writer.
- The ImageNet-S solver, on a tiny ResNet-18 at 32² with the JAX variables
  carried across, gives the JAX solver's per-combo top-1, Mean, Std and
  ``acc_var_neg`` for 3 decoders × 2 resize modes; its decode-once dataset
  gives every combo's images as ``ImageTransfer`` does.

This is the only port test file that imports TensorFlow (through the JAX
package's ffmpeg axis).
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import io
import json

import cv2
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.models import convert
from robustart_torch.noise import imagenet_s as P
from robustart_torch.noise import jpeg as port_jpeg
from robustart_torch.solvers import multi_eval_decoder_resize_solver as port_s
from robustart_tpu.core.config import Config
from robustart_tpu.models.torch_convert import flatten
from robustart_tpu.noise import imagenet_s as J
from robustart_tpu.solvers.multi_eval_decoder_resize_solver import MultiEvalDecoderResizeSolver
from tests.test_torch_port_resnet import numpy_init


def _jpeg(h, w, seed=0, mode="RGB", **save):
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, "JPEG", **save)
    return buf.getvalue()


FILES = {
    "420_odd": lambda: _jpeg(37, 53, quality=85),
    "444": lambda: _jpeg(24, 31, quality=92, subsampling=0),
    "422": lambda: _jpeg(29, 40, quality=75, subsampling=1),
    "gray": lambda: _jpeg(21, 34, mode="L", quality=85),
    "progressive": lambda: _jpeg(33, 47, quality=85, progressive=True),
    "420_plain_upsample": lambda: _jpeg(3, 5, quality=85),
}


def test_mode_tables_match():
    assert P.cv_resize_mode_dict == J.cv_resize_mode_dict
    assert P.pil_resize_mode_dict == J.pil_resize_mode_dict
    assert P.RESIZE_TYPES == J.RESIZE_TYPES and P.DECODER_TYPES == J.DECODER_TYPES
    assert P.ffmpeg_decoder_impl() == J.ffmpeg_decoder_impl()


@pytest.mark.parametrize("kind", list(FILES))
def test_decode_image_bitwise(kind):
    data = FILES[kind]()
    for decoder in P.DECODER_TYPES:
        for color in ("RGB", "BGR", "GRAY"):
            want = J.decode_image(data, decoder, color)
            got = P.decode_image(data, decoder, color)
            assert got.shape == want.shape, (decoder, color)
            np.testing.assert_array_equal(got, want, err_msg=f"{decoder} {color}")


def test_fast_idct_is_not_the_accurate_decode():
    """4:2:0: the fast IDCT and fancy upsampling differ from Pillow's
    accurate decode; 4:4:4: the route equals Pillow's own RGB decode under
    the same draft flag."""
    data = _jpeg(40, 48, quality=85)
    accurate = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert (P.decode_fast_idct(data) != accurate).any()
    data = _jpeg(40, 48, quality=85, subsampling=0)
    with Image.open(io.BytesIO(data)) as im:
        im.draft("RGB", im.size)
        im.decoderconfig = (1, 1)
        drafted = np.asarray(im)
    np.testing.assert_array_equal(P.decode_fast_idct(data), drafted)


def test_numpy_twins_equal_the_jpeg_module():
    """The route's numpy upsampling and colour conversion are bitwise
    ``noise/jpeg.py``'s torch ones (h2v1 is held by the 4:2:2 decode)."""
    rng = np.random.default_rng(3)
    for h, w in ((7, 9), (1, 3), (4, 1)):
        p = rng.integers(0, 256, (h, w)).astype(np.int32)
        want = port_jpeg.h2v2_fancy_up(torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(P.h2v2_fancy_up(p), want)
    y, cb, cr = (rng.integers(0, 256, (5, 6)).astype(np.int32) for _ in range(3))
    np.testing.assert_array_equal(
        P.ycc_to_rgb(y, cb, cr),
        port_jpeg.ycc_to_rgb(*map(torch.from_numpy, (y, cb, cr))).numpy().astype(np.uint8))


@pytest.mark.parametrize("kind", ["cmyk", "png"])
def test_fast_idct_refuses_what_it_cannot_hold(kind):
    if kind == "cmyk":
        data = _jpeg(16, 16, mode="CMYK", quality=85)
    else:
        buf = io.BytesIO()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "PNG")
        data = buf.getvalue()
    with pytest.raises(ValueError, match="img.x"):
        P.decode_fast_idct(data, "img.x")
    with pytest.raises(ValueError):
        P.decode_image(data, "ffmpeg")


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("s") / "img.jpg"
    path.write_bytes(_jpeg(61, 83, seed=5, quality=90))
    return str(path)


@pytest.mark.parametrize("resize", P.RESIZE_TYPES)
def test_image_transfer_bitwise(resize, image_file):
    for decoder in P.DECODER_TYPES:
        for transform, seed in (("val", None), ("train", 7)):
            kw = dict(file_path=image_file, decoder_type=decoder, resize_type=resize,
                      resize=24, transform_type=transform, return_online=True, seed=seed)
            want = J.ImageTransfer(**kw).getimage()
            got = P.ImageTransfer(**kw).getimage()
            np.testing.assert_array_equal(got, want, err_msg=f"{decoder} {transform}")
    assert np.array_equal(P.add_noise_for_imagenet_s(image_file, "ffmpeg", resize),
                          J.add_noise_for_imagenet_s(image_file, "ffmpeg", resize))


def test_image_transfer_offline_writer(tmp_path):
    root = tmp_path / "raw"
    (root / "a").mkdir(parents=True)
    for i in range(2):
        (root / "a" / f"{i}.jpg").write_bytes(_jpeg(40, 30, seed=i, quality=88))
    meta = tmp_path / "meta.txt"
    meta.write_text("a/0.jpg 3\na/1.jpg 5\n")
    for pkg, out in ((J, tmp_path / "jax"), (P, tmp_path / "port")):
        pkg.ImageTransfer(root_dir=str(root), meta_file=str(meta), save_root=str(out),
                          decoder_type="ffmpeg", resize_type="opencv-area", resize=16,
                          transform_type="train", seed=1)
    name = "ffmpeg_opencv-area.txt"
    assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    for i in range(2):
        rel = f"ffmpeg/opencv-area/a_{i}.jpg.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "port" / rel),
                                      np.load(tmp_path / "jax" / rel))


def _cfg(root, fake_root):
    return {
        "model": {"type": "resnet18", "kwargs": {"num_classes": 10}},
        "seed": 0,
        "data": {"batch_size": 4, "num_workers": 2, "input_size": 32, "read_from": "fake",
                 "fake_size": 6,
                 "test": {"decoders": ["pil", "opencv", "ffmpeg"],
                          "resize_types": ["pil-bilinear", "opencv-cubic"],
                          "save_acc_var_neg": True, "fake_root": str(fake_root)}},
        "saver": {"results_dir": str(root)},
    }


def test_solver_matches_jax(tmp_path, monkeypatch):
    numpy_init(monkeypatch)
    jax_solver = MultiEvalDecoderResizeSolver(Config(_cfg(tmp_path / "jax", tmp_path / "fj")))
    jax_solver.build_model(seed=0)
    want = jax_solver.evaluate()

    flat = {k: np.asarray(v) for k, v in flatten(jax_solver.classifier.variables).items()}
    ckpt = tmp_path / "ckpt.pth"
    torch.save(convert.state_dict_from_flax(flat), ckpt)
    cfg_path = tmp_path / "port.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfg(tmp_path / "port", tmp_path / "fp")))
    got = port_s.main(["--config", str(cfg_path), "--ckpt-filePath", str(ckpt),
                       "--device", "cpu"])
    assert got == want
    assert len(got["per_combo"]) == 6 and got["ffmpeg_decoder_impl"] == "tf-fast-idct"
    assert json.loads((tmp_path / "port" / "summary.json").read_text()) == got


def test_decode_once_dataset_equals_image_transfer(tmp_path):
    solver = port_s.MultiEvalDecoderResizeSolver(PortConfig(_cfg(tmp_path, tmp_path / "f")),
                                                 device="cpu")
    root, meta = solver._resolve_data(solver.cfg.data.test, 32)
    resizes = ["pil-lanczos", "opencv-nearest", "pil-box"]
    for decoder in P.DECODER_TYPES:
        ds = port_s._CombinationDataset(root, meta, decoder, resizes, 32)
        for i in (0, 5):
            item = ds[i]
            for k, r in enumerate(resizes):
                want = P.ImageTransfer(file_path=f"{root}/{ds.metas[i][0]}", decoder_type=decoder,
                                       resize_type=r, resize=32, return_online=True).getimage()
                np.testing.assert_array_equal(item["image"][k], want)
    assert set(ds.timings) == {"decode", *resizes}
    assert cv2.INTER_AREA == P.cv_resize_mode_dict["opencv-area"]
