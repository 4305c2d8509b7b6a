"""The port's bilinear warp (K2): its plan and its arithmetic, on the CPU.

``csrc/warp_bilinear.cu`` runs on a card only; these tests hold the parts
of its design that are arithmetic on the CPU, with no JAX:

- :func:`warp_plan`'s grid gives every pixel of every image to one thread
  once, by the kernel's indexing, and refuses what the kernel does not take;
- the kernel's division-free 'reflect', written out in Python, is
  ``_reflect``;
- :func:`elastic_coords` and two warps and the clamp are elastic_transform.

The kernel against the plain version on the card is in
``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from robustart_torch.noise import corruptions as pc
from robustart_torch.ops import warp as kw

B, H, W = 2, 40, 56


def kernel_reflect(idx: int, n: int) -> int:
    """``reflect`` of ``csrc/warp_bilinear.cu``, branch by branch."""
    if 0 <= idx < n:
        return idx
    if -n <= idx < 0:
        return -1 - idx
    if n <= idx < 2 * n:
        return 2 * n - 1 - idx
    m = int(np.fmod(idx, 2 * n))  # C's %: the sign of the dividend
    if m < 0:
        m += 2 * n
    return 2 * n - 1 - m if m >= n else m


def _image(rng, b=B, h=H, w=W, c=3):
    return torch.from_numpy(rng.random((b, h, w, c), dtype=np.float32))


@pytest.mark.parametrize("h,w", [(56, 40), (224, 224), (57, 41), (1, 1), (40, 56)])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_warp_plan_covers_every_pixel_once(h, w, c):
    """The kernel's indexing over ``warp_plan``'s grid: block x of image n,
    thread t, its i-th pixel x · threads · pixels + i · threads + t where
    that is below H · W."""
    plan = kw.warp_plan(3, h, w, c)
    assert plan["launches"] == 1 and plan["threads"] == 256
    blocks, images = plan["grid"]
    assert images == 3 and blocks < 2**31
    per_block = plan["threads"] * plan["pixels"]
    t = torch.arange(plan["threads"])
    cover = torch.zeros(h * w, dtype=torch.int64)
    for x in range(blocks):
        for i in range(plan["pixels"]):
            pix = x * per_block + i * plan["threads"] + t
            cover.index_add_(0, pix[pix < h * w], torch.ones_like(pix[pix < h * w]))
    assert bool((cover == 1).all())
    assert (blocks - 1) * per_block < h * w  # no block without a pixel


def test_warp_plan_refusals():
    for shape in ((70000, 56, 40, 3), (0, 56, 40, 3), (3, 0, 40, 3), (3, 56, 40, 0)):
        with pytest.raises(ValueError):
            kw.warp_plan(*shape)
    assert kw.warp_plan(65535, 1, 1, 1)["grid"] == (1, 65535)


def test_kernel_reflect_is_scipy_reflect():
    for n in (1, 2, 3, 40, 56, 224):
        idx = torch.arange(-7 * n - 3, 7 * n + 3)
        want = kw._reflect(idx, n).tolist()
        assert [kernel_reflect(int(i), n) for i in idx] == want


@pytest.mark.parametrize("severity", [1, 3, 5])
def test_elastic_coords_and_two_warps_are_elastic_transform(severity):
    rng = np.random.default_rng(severity)
    x = _image(rng)
    want = pc.elastic_transform(x, severity, generator=torch.Generator().manual_seed(5))
    first, second = pc.elastic_coords(x, severity, generator=torch.Generator().manual_seed(5))
    got = torch.clamp(kw.warp_bilinear(kw.warp_bilinear(x, *first), *second), 0.0, 1.0)
    assert torch.equal(got, want)
    cc = pc.ELASTIC_SEVERITY[severity - 1][2]
    draws = {"affine": torch.from_numpy(rng.uniform(-cc, cc, (B, 3, 2)).astype(np.float32)),
             "field_x": torch.from_numpy(rng.uniform(-1, 1, (B, H, W)).astype(np.float32)),
             "field_y": torch.from_numpy(rng.uniform(-1, 1, (B, H, W)).astype(np.float32))}
    first, second = pc.elastic_coords(x, severity, **draws)
    for t in (*first, *second):
        assert t.shape == (B, H, W) and t.dtype == torch.float32 and t.is_contiguous()
    got = torch.clamp(kw.warp_bilinear(kw.warp_bilinear(x, *first), *second), 0.0, 1.0)
    assert torch.equal(got, pc.elastic_transform(x, severity, **draws))
