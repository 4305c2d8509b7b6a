"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Each test is marked ``gpu`` and skips without CUDA: a CUDA kernel has no CPU
mode. The file imports no JAX, so that on a machine with a card and without
JAX it runs alone (``tests/conftest.py`` imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

The shapes are odd (3×56×40, 3×31×17) so that no block is full. K2 and K3
round every step as their plain versions do and K4 and K5 copy or take
minima, so all but K1 are held bitwise; K1's plain version divides where
torch's CUDA division multiplies by a reciprocal (``PERF.md``).
"""

import pytest
import torch

from robustart_torch.noise.corruptions import MOTION_BANK, SNOW_BANK
from robustart_torch.ops import build
from robustart_torch.ops import motion as km
from robustart_torch.ops import noise as k1
from robustart_torch.ops import warp as kw

B, H, W = 3, 56, 40


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def test_library_name_follows_source_and_flags():
    """A changed source or flag set builds a new library, never a stale one."""
    a = build.library_path("chamfer")
    assert a.parent == build.BUILD_DIR and a.name.startswith("chamfer-")
    assert a == build.library_path("chamfer") != build.library_path("glass_shuffle")
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}


@pytest.mark.gpu
def test_cuda_fused_noise_matches_plain_version(gen):
    x = torch.randint(0, 256, (B, 31, 17, 3), dtype=torch.uint8, device="cuda",
                      generator=gen)
    before = k1.fused_noise_normalize.launches
    got = k1.fused_noise_normalize(x, 5, noise="gaussian_noise", sigma=0.18)
    ref = k1.fused_noise_normalize_reference(x, 5, noise="gaussian_noise", sigma=0.18)
    torch.cuda.synchronize()
    assert k1.fused_noise_normalize.launches == before + 1
    assert (got != ref).float().mean() <= 1e-4


@pytest.mark.gpu
def test_cuda_warp_matches_plain_version(gen):
    img = torch.rand((B, H, W, 3), device="cuda", generator=gen)
    cy = torch.rand((B, H, W), device="cuda", generator=gen) * 200 - 70
    cx = torch.rand((B, H, W), device="cuda", generator=gen) * 150 - 50
    before = kw.warp_bilinear.launches
    got = kw.warp_bilinear(img, cy, cx)
    torch.cuda.synchronize()
    assert kw.warp_bilinear.launches == before + 1
    assert torch.equal(got, kw.warp_bilinear_reference(img, cy, cx))


@pytest.mark.gpu
@pytest.mark.parametrize("c,radius,sigma,bank", [(3, 20.0, 15.0, MOTION_BANK),
                                                 (1, 12.0, 12.0, SNOW_BANK)])
def test_cuda_motion_taps_matches_plain_version(gen, c, radius, sigma, bank):
    img = torch.rand((B, H, W, c), device="cuda", generator=gen)
    idx = torch.tensor([0, 13, 31], device="cuda")
    rows = km.tap_rows(idx, radius, sigma, bank)
    before = km.motion_taps.launches
    got = km.motion_blur_bank(img, idx, radius, sigma, bank)
    torch.cuda.synchronize()
    assert km.motion_taps.launches == before + 1
    assert torch.equal(got, km.motion_taps_reference(img, *rows))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 4])
def test_cuda_glass_shuffle_matches_plain_version(gen, d):
    x = torch.rand((B, H, W, 3), device="cuda", generator=gen)
    code = torch.randint(0, (2 * d) ** 2, (B, H, W), device="cuda",
                         generator=gen).to(torch.uint8)
    got = km.glass_shuffle(x, code, d)
    torch.cuda.synchronize()
    assert torch.equal(got, km.glass_shuffle_reference(x, code, d))


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [1, 12])
def test_cuda_chamfer_matches_plain_version(gen, iters):
    dist0 = torch.where(torch.rand((B, H, W), device="cuda", generator=gen) < 0.02,
                        0.0, 20.0)
    before = km.chamfer.launches
    got = km.chamfer(dist0, 20.0, iters)
    torch.cuda.synchronize()
    assert km.chamfer.launches == before + iters
    assert torch.equal(got, km.chamfer_reference(dist0, 20.0, iters))
