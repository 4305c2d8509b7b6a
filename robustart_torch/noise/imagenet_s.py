"""ImageNet-S system noise: decoder × resize implementation variation.

Counterpart of ``robustart_tpu/noise/imagenet_s.py`` (the reference's
``ImageTransfer``). The benchmark's signal is the numeric difference between
image decoders {pil, opencv, ffmpeg} and resize implementations (6 PIL and 5
OpenCV modes), so decode and resize run on the host through the same Pillow
and OpenCV calls as the JAX package's, byte for byte. OpenCV is imported only
inside the functions that call it; the mode table holds its flags as plain
ints (``cv2.INTER_*``).

The ``ffmpeg`` axis runs the ``ffmpeg`` binary where it exists. Elsewhere the
JAX package decodes with TensorFlow's ``decode_jpeg(dct_method=
"INTEGER_FAST")``; the port reaches the same pixels without TensorFlow
(:func:`decode_fast_idct`): Pillow's JPEG decoder, with its private draft
flag set, runs libjpeg's fast integer IDCT and returns the YCbCr planes with
the chroma replicated; every second chroma sample taken back, libjpeg's fancy
upsampling (jdsample.c h2v2 and h2v1) and colour conversion (jdcolor.c) give
TensorFlow's decode bit for bit. These run in numpy here, twins of
``noise/jpeg.py::h2v2_fancy_up`` and ``ycc_to_rgb`` (the tests hold them
equal): the loader decodes in many host threads, where torch's CPU ops
would each start their own thread team. A file the route cannot hold to
that (CMYK, YCCK, RGB-coded, other sampling factors) is refused, never
decoded by the accurate IDCT in its place.

Transforms (reference imagenet_s_gen.py:106-148):
- val:   resize to (size·8/7) with the chosen mode, center crop ``size``
- train: torchvision-style RandomResizedCrop params, then resize
"""

from __future__ import annotations

import io
import math
import os
import os.path as osp
import random
import shutil
import subprocess

import numpy as np
from PIL import Image

from robustart_torch.noise.jpeg import _ONE_HALF, _SCALEBITS, _fix

pil_resize_mode_dict = {
    "pil-bilinear": Image.BILINEAR,
    "pil-nearest": Image.NEAREST,
    "pil-box": Image.BOX,
    "pil-hamming": Image.HAMMING,
    "pil-cubic": Image.BICUBIC,
    "pil-lanczos": Image.LANCZOS,
}

# cv2.INTER_NEAREST, INTER_LINEAR, INTER_AREA, INTER_CUBIC, INTER_LANCZOS4
cv_resize_mode_dict = {
    "opencv-nearest": 0,
    "opencv-bilinear": 1,
    "opencv-area": 3,
    "opencv-cubic": 2,
    "opencv-lanczos": 4,
}

DECODER_TYPES = ("pil", "opencv", "ffmpeg")
RESIZE_TYPES = tuple(pil_resize_mode_dict) + tuple(cv_resize_mode_dict)



def h2v1_fancy_up(p: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample of an int32 (h, w) plane → (h, 2w):
    each output (3·nearer + further + 1 or 2) >> 2 along the row, the first
    and last columns copied."""
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + np.concatenate([p[:, :1], p[:, :-1]], axis=1) + 1) >> 2
    out[:, 1::2] = (3 * p + np.concatenate([p[:, 1:], p[:, -1:]], axis=1) + 2) >> 2
    out[:, 0], out[:, -1] = p[:, 0], p[:, -1]
    return out


def h2v2_fancy_up(p: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample of an int32 (h, w) plane → (2h, 2w),
    the integer triangle filter (``noise/jpeg.py::h2v2_fancy_up`` in numpy)."""
    near = np.repeat(p, 2, axis=0)
    far = np.empty_like(near)
    far[0::2] = np.concatenate([p[:1], p[:-1]], axis=0)
    far[1::2] = np.concatenate([p[1:], p[-1:]], axis=0)
    cs = 3 * near + far  # the column sums
    out = np.empty((cs.shape[0], 2 * cs.shape[1]), np.int32)
    out[:, 0::2] = (3 * cs + np.concatenate([cs[:, :1], cs[:, :-1]], axis=1) + 8) >> 4
    out[:, 1::2] = (3 * cs + np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1) + 7) >> 4
    out[:, 0] = (cs[:, 0] * 4 + 8) >> 4
    out[:, -1] = (cs[:, -1] * 4 + 7) >> 4
    return out


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert of sample planes (0..255) → (..., 3) uint8
    (``noise/jpeg.py::ycc_to_rgb`` in numpy)."""
    y = y.astype(np.int32)
    cb, cr = cb - 128, cr - 128
    out = np.empty(y.shape + (3,), np.int32)
    out[..., 0] = y + ((_fix(1.40200) * cr + _ONE_HALF) >> _SCALEBITS)
    out[..., 1] = y + ((-_fix(0.34414) * cb - _fix(0.71414) * cr + _ONE_HALF) >> _SCALEBITS)
    out[..., 2] = y + ((_fix(1.77200) * cb + _ONE_HALF) >> _SCALEBITS)
    return np.clip(out, 0, 255).astype(np.uint8)


# luma sampling factors (h, v) → the chroma upsampler libjpeg runs; every
# chroma component is sampled (1, 1)
_UPSAMPLERS = {(1, 1): None, (2, 1): h2v1_fancy_up, (2, 2): h2v2_fancy_up}


def decode_image(
    filebytes: np.ndarray | bytes,
    decoder_type: str = "pil",
    color_mode: str = "RGB",
    filepath: str | None = None,
) -> np.ndarray:
    """Decode image bytes with the chosen backend (HWC uint8, RGB)."""
    if isinstance(filebytes, bytes):
        filebytes = np.frombuffer(filebytes, dtype=np.uint8)
    if decoder_type == "pil":
        with Image.open(io.BytesIO(filebytes.tobytes())) as img:
            img = img.convert("RGB")
            if color_mode == "BGR":
                r, g, b = img.split()
                img = Image.merge("RGB", (b, g, r))
            elif color_mode == "GRAY":
                img = img.convert("L")
            return np.array(img)
    if decoder_type == "opencv":
        import cv2

        img = cv2.imdecode(filebytes, cv2.IMREAD_COLOR)
        if color_mode == "RGB":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        elif color_mode == "GRAY":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return img
    if decoder_type == "ffmpeg":
        if shutil.which("ffmpeg") is not None and filepath is not None:
            # the reference's path (imagenet_s_gen.py:203-218); BGR and GRAY
            # are honoured below as the JAX package honours them
            import cv2

            height, width = cv2.imdecode(filebytes, cv2.IMREAD_COLOR).shape[:2]
            out = subprocess.run(
                ["ffmpeg", "-v", "error", "-i", filepath, "-f", "rawvideo",
                 "-pix_fmt", "rgb24", "pipe:"],
                capture_output=True,
                check=True,
            ).stdout
            img = np.frombuffer(out, np.uint8).reshape([height, width, 3])
        else:
            img = decode_fast_idct(filebytes, filepath)
        if color_mode == "BGR":
            img = img[..., ::-1]
        elif color_mode == "GRAY":
            import cv2

            img = cv2.cvtColor(np.ascontiguousarray(img), cv2.COLOR_RGB2GRAY)
        return img
    raise NotImplementedError(f"decoder_type {decoder_type!r}")


def ffmpeg_decoder_impl() -> str:
    """Which implementation serves the 'ffmpeg' decoder axis here: 'ffmpeg'
    where the binary exists, else 'tf-fast-idct', the name the JAX package
    gives TensorFlow's fast-integer-IDCT decode. The port computes those
    same pixels without TensorFlow (:func:`decode_fast_idct`), so results
    of the two packages stay comparable under one name."""
    return "ffmpeg" if shutil.which("ffmpeg") is not None else "tf-fast-idct"


def decode_fast_idct(filebytes: np.ndarray | bytes, name: str | None = None) -> np.ndarray:
    """A JPEG's pixels as TensorFlow's ``decode_jpeg(channels=3,
    dct_method="INTEGER_FAST")`` gives them (HWC uint8 RGB), with no
    TensorFlow: libjpeg's fast integer IDCT through Pillow's draft flag,
    then libjpeg's fancy upsampling and YCbCr → RGB. Grayscale files come
    back replicated to three channels. Raises ``ValueError`` naming the file
    for a file the route cannot decode bit for bit (not a JPEG, CMYK/YCCK,
    RGB-coded, or chroma sampling other than 4:4:4, 4:2:2, 4:2:0)."""
    data = filebytes if isinstance(filebytes, bytes) else np.asarray(filebytes).tobytes()
    name = name or "<bytes>"
    with Image.open(io.BytesIO(data)) as im:
        if im.format != "JPEG":
            raise ValueError(f"{name}: the fast-IDCT decoder takes JPEG files, not {im.format}")
        if im.mode not in ("RGB", "L") or im.info.get("adobe_transform") == 0:
            raise ValueError(f"{name}: the fast-IDCT decoder takes YCbCr and grayscale JPEGs, "
                             f"not {im.mode}")
        luma = tuple(im.layer[0][1:3])
        if im.mode == "RGB" and (luma not in _UPSAMPLERS
                                 or any(tuple(c[1:3]) != (1, 1) for c in im.layer[1:])):
            raise ValueError(f"{name}: chroma sampling {[tuple(c[1:3]) for c in im.layer]} is "
                             "not one the fast-IDCT decoder holds bit for bit")
        want = "YCbCr" if im.mode == "RGB" else "L"
        im.draft(want, im.size)
        im.decoderconfig = (1, 1)  # (scale, draft): libjpeg's fast IDCT, no upsampling
        if im.mode != want:
            raise ValueError(f"{name}: Pillow did not decode the planes as {want}")
        planes = np.asarray(im)
    if want == "L":
        return np.repeat(planes[..., None], 3, axis=-1)
    h, w = planes.shape[:2]
    hs, vs = luma
    # Pillow replicates each chroma sample over its hs × vs block
    cb = planes[::vs, ::hs, 1].astype(np.int32)
    cr = planes[::vs, ::hs, 2].astype(np.int32)
    up = _UPSAMPLERS[luma]
    if up is not None:
        # libjpeg upsamples plainly where a chroma row is 2 samples or fewer
        if cb.shape[1] > 2:
            cb, cr = up(cb), up(cr)
        else:
            cb = cb.repeat(hs, 1).repeat(vs, 0)
            cr = cr.repeat(hs, 1).repeat(vs, 0)
        cb, cr = cb[:h, :w], cr[:h, :w]
    return ycc_to_rgb(planes[..., 0], cb, cr)


def random_resized_crop_params(
    shape_hw: tuple[int, int],
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    rng: random.Random | None = None,
) -> tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params (imagenet_s_gen.py:222-263)."""
    r = rng or random
    height, width = shape_hw
    area = height * width
    for _ in range(10):
        target_area = r.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(r.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = r.randint(0, height - h)
            j = r.randint(0, width - w)
            return i, j, h, w
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w = width
        h = height
    return (height - h) // 2, (width - w) // 2, h, w


def _pil_resize(img: Image.Image, size, interpolation) -> Image.Image:
    if isinstance(size, int):
        w, h = img.size
        if (w <= h and w == size) or (h <= w and h == size):
            return img
        if w < h:
            return img.resize((size, int(size * h / w)), interpolation)
        return img.resize((int(size * w / h), size), interpolation)
    return img.resize(size[::-1], interpolation)


def resize_decoded(img: np.ndarray, resize_type: str, size: tuple[int, int],
                   transform_type: str = "val",
                   crop: tuple[int, int, int, int] | None = None) -> np.ndarray:
    """The resize step of :class:`ImageTransfer` on a decoded image: ``train``
    crops ``crop`` = (i, j, h, w) and resizes it to ``size``, ``val``
    resizes to size·8/7 and center-crops ``size``."""
    th, tw = size
    if transform_type == "train":
        i, j, h, w = crop
        if resize_type.startswith("pil"):
            pimg = Image.fromarray(img).crop((j, i, j + w, i + h))
            return np.asarray(_pil_resize(pimg, size, pil_resize_mode_dict[resize_type]))
        import cv2

        return cv2.resize(img[i : i + h, j : j + w], size,
                          interpolation=cv_resize_mode_dict[resize_type])
    if transform_type == "val":
        if resize_type.startswith("pil"):
            first = tuple(int(s * 8 / 7) for s in size)
            pimg = _pil_resize(Image.fromarray(img), first, pil_resize_mode_dict[resize_type])
            ww, hh = pimg.size
            ii = int(round((hh - th) / 2.0))
            jj = int(round((ww - tw) / 2.0))
            return np.asarray(pimg.crop((jj, ii, jj + tw, ii + th)))
        import cv2

        width, height = tuple(int(s * 8 / 7) for s in size)
        out = cv2.resize(img, (width, height), interpolation=cv_resize_mode_dict[resize_type])
        hh, ww = out.shape[0], out.shape[1]
        dy = int(round((hh - th) / 2.0))
        dx = int(round((ww - tw) / 2.0))
        return out[dy : dy + th, dx : dx + tw]
    raise NotImplementedError(f"transform_type {transform_type!r}")


class ImageTransfer:
    """Decode + resize an image with a chosen (decoder, resize) combo.

    Reference API (imagenet_s_gen.py:38): ``return_online=True`` +
    ``file_path`` processes one image via ``getimage()``; offline mode
    iterates a meta file ("path label" lines) and writes per-image ``.npy``
    plus a new meta file.
    """

    def __init__(
        self,
        root_dir: str | None = None,
        meta_file: str | None = None,
        save_root: str | None = None,
        decoder_type: str = "pil",
        resize_type: str = "pil-bilinear",
        resize: int | tuple[int, int] = 224,
        transform_type: str = "val",
        return_online: bool = False,
        file_path: str | None = None,
        seed: int | None = None,
    ):
        assert decoder_type in DECODER_TYPES, decoder_type
        assert resize_type in RESIZE_TYPES, resize_type
        self.root_dir = root_dir
        self.meta_file = meta_file
        self.save_root = save_root
        self.decoder_type = decoder_type
        self.resize_type = resize_type
        self.transform_type = transform_type
        self.return_online = return_online
        self.file_path = file_path
        self.resize = resize if isinstance(resize, tuple) else (resize, resize)
        self.color_mode = "RGB"
        self._rng = random.Random(seed) if seed is not None else random

        if not return_online:
            self._run_offline()

    # -- offline dataset writer (imagenet_s_gen.py:56-79) --
    def _run_offline(self) -> None:
        with open(self.meta_file) as f:
            lines = f.readlines()
        metas = []
        for line in lines:
            filename, label = line.rstrip().split()
            metas.append({"filename": filename, "label": label})
        save_dir = osp.join(self.save_root, self.decoder_type, self.resize_type)
        os.makedirs(save_dir, exist_ok=True)
        new_meta_name = osp.join(self.save_root, f"{self.decoder_type}_{self.resize_type}.txt")
        with open(new_meta_name, "w") as new_meta:
            for meta in metas:
                np_image = self._process(osp.join(self.root_dir, meta["filename"]))
                save_name = meta["filename"].replace(os.sep, "_") + ".npy"
                np.save(osp.join(save_dir, save_name), np_image)
                rel = osp.join(self.decoder_type, self.resize_type, save_name)
                new_meta.write(f"{rel} {meta['label']}\n")

    # -- online single image (imagenet_s_gen.py:86-103) --
    def getimage(self) -> np.ndarray:
        assert self.return_online, "construct with return_online=True"
        return self._process(self.file_path)

    def _process(self, path: str) -> np.ndarray:
        with open(path, "rb") as f:
            filebytes = np.frombuffer(f.read(), dtype=np.uint8)
        img = decode_image(filebytes, self.decoder_type, self.color_mode, path)
        crop = random_resized_crop_params(
            img.shape[:2], rng=self._rng if self._rng is not random else None)
        return resize_decoded(img, self.resize_type, self.resize, self.transform_type, crop)


def add_noise_for_imagenet_s(
    image: str,
    decoder_type: str = "pil",
    resize_type: str = "pil-bilinear",
    transform_type: str = "val",
) -> np.ndarray:
    """Facade entry (reference add_noise_utils.py:34-38): file path in,
    decoded+resized array out."""
    assert isinstance(image, str), "Input of imagenet-S can only be file path"
    return ImageTransfer(
        file_path=image,
        decoder_type=decoder_type,
        resize_type=resize_type,
        transform_type=transform_type,
        return_online=True,
    ).getimage()
