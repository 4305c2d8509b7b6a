"""The port's fused noise kernel K1 and noise corruptions against the JAX package.

- The plain PyTorch K1 (``fused_noise_normalize_reference``) with all-zero
  random words against the Pallas kernel run by the TPU interpreter, which
  stubs ``prng_random_bits`` to zeros: every mode × output at (2, 32, 32, 3).
- The port's Philox4x32-10 against Random123's known-answer vectors, and
  its streams' independence and statistics.
- ``gaussian/shot/impulse/speckle_noise`` against ``jax_kernels`` with the
  JAX draw injected.
- On a CUDA machine, the CUDA kernel against its plain version.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.noise import corruptions as port_corr
from robustart_torch.ops import noise as k1
from robustart_tpu.noise.corruptions import jax_kernels
from robustart_tpu.ops.pallas_noise import fused_noise_normalize as jax_k1

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
SIGMA = {"gaussian_noise": 0.1, "speckle_noise": 0.35, "impulse_noise": 0.09,
         "shot_noise": 12.0}
OUTPUTS = {
    "bf16": ("normalized", torch.bfloat16, jnp.bfloat16),
    "f32": ("normalized", torch.float32, jnp.float32),
    "int8": ("centered_u8", torch.int8, jnp.int8),
}


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), np.uint8)


@pytest.mark.parametrize("out", sorted(OUTPUTS))
@pytest.mark.parametrize("noise", k1.NOISE_MODES)
def test_plain_k1_matches_pallas_interpret(imgs, noise, out):
    output, t_dtype, j_dtype = OUTPUTS[out]
    ref = np.asarray(jax_k1(
        imgs, 0, noise=noise, sigma=SIGMA[noise], mean=MEAN, std=STD,
        out_dtype=j_dtype, interpret=True, output=output,
    ).astype(jnp.float32))
    got = k1.fused_noise_normalize_reference(
        torch.from_numpy(imgs), 0, noise=noise, sigma=SIGMA[noise], mean=MEAN,
        std=STD, out_dtype=t_dtype, output=output, bits=0,
    )
    if out == "int8":
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int8))
    elif out == "f32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    else:  # within one bf16 ulp (8 mantissa bits)
        got = got.float().numpy()
        ulp = np.maximum(np.abs(ref), 1e-30) * 2.0**-7
        assert np.all(np.abs(got - ref) <= ulp)


def test_zero_draw_levels(imgs):
    """All-zero words: the normal is √(50 ln 2) ≈ 5.887, so gaussian σ=0.1
    takes pixel 95 to level 245, and impulse takes every pixel to 0."""
    x = torch.full((1, 2, 2, 3), 95, dtype=torch.uint8)
    g = k1.fused_noise_normalize_reference(
        x, 0, noise="gaussian_noise", sigma=0.1, out_dtype=torch.int8,
        output="centered_u8", bits=0,
    )
    assert torch.all(g.to(torch.int32) + 128 == 245)
    i = k1.fused_noise_normalize_reference(
        torch.from_numpy(imgs), 0, noise="impulse_noise", sigma=0.09,
        out_dtype=torch.int8, output="centered_u8", bits=0,
    )
    assert torch.all(i.to(torch.int32) + 128 == 0)


@pytest.mark.parametrize(
    "counter,key,expect",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_philox_known_answers(counter, key, expect):
    assert tuple(int(v) for v in k1.philox4x32_10(counter, key)) == expect


def test_streams_repeat_and_separate():
    a = k1.philox_bits(7, 3, 1000)
    assert torch.equal(a, k1.philox_bits(7, 3, 1000))
    assert int(a.min()) >= 0 and int(a.max()) <= 0xFFFFFFFF
    b = k1.philox_bits(8, 3, 1000)
    assert not torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    # the TPU kernel's seed + i keying would make these two equal
    assert (a[1] == b[0]).float().mean() < 0.01
    assert (a[1, 1:] == b[0, :-1]).float().mean() < 0.01


def test_gaussian_statistics_and_identical_images():
    x = torch.full((4, 64, 64, 3), 128, dtype=torch.uint8)
    out = k1.fused_noise_normalize(
        x, 3, noise="gaussian_noise", sigma=0.1, mean=MEAN, std=STD,
        out_dtype=torch.float32,
    )
    clean = 128.0 / 255.0
    diff = out.numpy() * np.asarray(STD) + np.asarray(MEAN) - clean
    assert abs(diff.std() - 0.1) < 0.005
    assert abs(diff.mean()) < 0.005
    assert not torch.equal(out[0], out[1])
    assert torch.equal(out, k1.fused_noise_normalize(
        x, 3, noise="gaussian_noise", sigma=0.1, mean=MEAN, std=STD,
        out_dtype=torch.float32,
    ))


def test_cpu_dispatch_is_plain_version(imgs):
    x = torch.from_numpy(imgs)
    before = k1.fused_noise_normalize.launches
    got = k1.fused_noise_normalize(x, 11, noise="speckle_noise", sigma=0.2)
    ref = k1.fused_noise_normalize_reference(x, 11, noise="speckle_noise", sigma=0.2)
    assert torch.equal(got, ref) and got.dtype == torch.bfloat16
    assert k1.fused_noise_normalize.launches == before


@pytest.mark.parametrize(
    "kwargs,exc",
    [
        ({"noise": "fog"}, ValueError),
        ({"output": "centered_u8", "out_dtype": torch.float32}, ValueError),
        ({"output": "normalized", "out_dtype": torch.int8}, ValueError),
        ({"seed": -1}, ValueError),
        ({"images_u8": torch.zeros((2, 4, 4, 3), dtype=torch.float32)}, TypeError),
        ({"images_u8": torch.zeros((2, 4, 4, 4), dtype=torch.uint8)}, ValueError),
    ],
)
def test_wrapper_rejects_bad_arguments(kwargs, exc):
    args = {"images_u8": torch.zeros((2, 4, 4, 3), dtype=torch.uint8), "seed": 0}
    args.update(kwargs)
    with pytest.raises(exc):
        k1.fused_noise_normalize(args.pop("images_u8"), args.pop("seed"), **args)


@pytest.mark.parametrize("severity", [1, 3, 5])
@pytest.mark.parametrize(
    "name,draw",
    [("gaussian_noise", "normal"), ("speckle_noise", "normal"),
     ("impulse_noise", "uniform"), ("shot_noise", "uniform")],
)
def test_corruption_matches_jax(name, draw, severity):
    x = np.random.default_rng(severity).random((16, 16, 3), dtype=np.float32)
    key = jax.random.key(severity)
    # jitted, as the JAX solver runs it: XLA turns shot_noise's ``n / c`` into
    # the product by the float32 reciprocal
    fn = jax.jit(getattr(jax_kernels, name), static_argnums=2)
    ref = np.asarray(fn(jnp.asarray(x), key, severity))
    sampler = jax.random.normal if draw == "normal" else jax.random.uniform
    injected = np.array(sampler(key, x.shape, jnp.float32))
    got = getattr(port_corr, name)(
        torch.from_numpy(x), severity, **{draw: torch.from_numpy(injected)}
    ).numpy()
    if name in ("shot_noise", "impulse_noise"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_corrupt_batch_and_roundtrip():
    x = torch.rand((2, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    y = port_corr.corrupt_batch(x, "shot_noise", 2, generator=gen)
    assert y.shape == x.shape and float(y.min()) >= 0 and float(y.max()) <= 1
    # every uint8 level and the shot-noised batch, against the jitted JAX
    # roundtrip (the solver's program, where ``/ 255.0`` is a product)
    levels = torch.arange(256, dtype=torch.float32) / 255.0 + 0.5 / 255.0
    jit_roundtrip = jax.jit(jax_kernels._uint8_roundtrip)
    for z in (levels, y):
        q = port_corr.uint8_roundtrip(z)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jit_roundtrip(jnp.asarray(z.numpy()))))
    assert torch.equal(port_corr.uint8_grid(levels), torch.arange(256, dtype=torch.float32))
    with pytest.raises(ValueError, match="unknown corruption"):
        port_corr.corrupt_batch(x, "fogg", 1)
    assert port_corr.CORRUPTION_ORDER == jax_kernels.CORRUPTION_ORDER


@pytest.mark.gpu
@pytest.mark.parametrize("out", sorted(OUTPUTS))
@pytest.mark.parametrize("noise", k1.NOISE_MODES)
def test_cuda_kernel_matches_plain_version(noise, out):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    output, dtype, _ = OUTPUTS[out]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (3, 31, 17, 3), dtype=torch.uint8, device="cuda",
                      generator=gen)
    got = k1.fused_noise_normalize(x, 5, noise=noise, sigma=SIGMA[noise],
                                   out_dtype=dtype, output=output)
    ref = k1.fused_noise_normalize_reference(x, 5, noise=noise, sigma=SIGMA[noise],
                                             out_dtype=dtype, output=output)
    torch.cuda.synchronize()
    assert (got != ref).float().mean() <= 1e-4
