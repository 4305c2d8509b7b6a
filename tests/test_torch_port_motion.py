"""K3's tiling on the CPU: the arithmetic of ``csrc/motion_taps.cu``.

- :func:`motion_plan`'s persistent grid gives every pixel of every image to
  one thread once, partial tiles included, sizes its blocks by what an SM
  holds, and refuses what the kernel does not take;
- every tile's source box fits the plan's budget for every bank angle at
  every severity of motion_blur (C = 3) and snow (C = 1), and stays within
  a block's 227 KB;
- the box route written out in plain torch (each tile's box filled through
  the clamp, the taps summed from it in tap order, a tile over the budget
  gathering) equals ``motion_taps_reference`` bit for bit.

The kernel against the plain version on the card is in
``tests/test_torch_port_cuda.py``. No JAX here: the plain version was held
to the TPU kernel in ``tests/test_torch_port_corruptions.py``.
"""

import numpy as np
import pytest
import torch

from robustart_torch.noise.corruptions import (
    MOTION_BANK,
    MOTION_SEVERITY,
    SNOW_BANK,
    SNOW_SEVERITY,
)
from robustart_torch.ops import motion as km

B, H, W = 2, 40, 56
# (corruption, severity, C, radius, sigma, bank): every severity's taps
TAPS = ([("motion_blur", s + 1, 3, float(r), float(g), MOTION_BANK)
         for s, (r, g) in enumerate(MOTION_SEVERITY)]
        + [("snow", s + 1, 1, float(c[4]), float(c[5]), SNOW_BANK)
           for s, c in enumerate(SNOW_SEVERITY)])
IDS = [f"{t[0]}{t[1]}" for t in TAPS]


def emulate(img, dy, dx, wt, box_bytes):
    """The kernel's routes in plain torch: per image and tile, the box of
    :func:`tile_box` (a full tile's) filled through the clamp and the taps
    summed from it, or, where the box exceeds ``box_bytes``, the per-tap
    clamped gather.
    Returns the output and the (box, gather) tile counts."""
    b, h, w, c = img.shape
    th, tw = km.MOTION_TILE
    out = torch.empty_like(img)
    routes = [0, 0]
    for n in range(b):
        y, x = dy[n].to(torch.int64).clamp(-h, h), dx[n].to(torch.int64).clamp(-w, w)
        for r0 in range(0, h, th):
            for c0 in range(0, w, tw):
                y0, x0, bh, bw = km.tile_box(dy[n], dx[n], (r0, c0), h, w)
                rows = torch.arange(r0, min(r0 + th, h)).view(-1, 1)
                cols = torch.arange(c0, min(c0 + tw, w)).view(1, -1)
                acc = torch.zeros((rows.shape[0], cols.shape[1], c))
                boxed = bh * ((bw * c + 6) // 4 * 4) * 4 <= box_bytes  # rows padded
                routes[not boxed] += 1
                if boxed:
                    box = img[n][torch.arange(y0, y0 + bh).clamp(0, h - 1)][
                        :, torch.arange(x0, x0 + bw).clamp(0, w - 1)]
                for t in range(dy.shape[1]):
                    if boxed:
                        tap = box[rows - y0 + y[t], cols - x0 + x[t]]
                    else:
                        tap = img[n][(rows + y[t]).clamp(0, h - 1), (cols + x[t]).clamp(0, w - 1)]
                    acc = acc + wt[n, t] * tap
                out[n, r0:r0 + th, c0:c0 + tw] = acc
    return out, routes


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("h,w", [(224, 224), (40, 56), (8, 8), (57, 41), (1, 33)])
def test_motion_plan_covers_every_pixel_once(h, w, sms):
    """The kernel's indexing over ``motion_plan``'s persistent grid: block k
    walks tiles [k · total // blocks, (k + 1) · total // blocks) in order
    (image, tile row, tile column); thread (warp, lane) of a 32 × 32 tile
    takes column c0 + lane and rows r0 + warp + 8k, k < 4, where inside the
    image. Every block has a tile, every pixel one thread."""
    b = 3
    plan = km.motion_plan(b, h, w, 3, sms=sms)
    assert plan["launches"] == 1 and plan["threads"] == 256 and plan["pixels"] == 4
    (blocks,), (ty, tx), (th, tw) = plan["grid"], plan["tiles"], plan["tile"]
    total = plan["total"]
    assert total == b * ty * tx and (ty - 1) * th < h <= ty * th and (tx - 1) * tw < w <= tx * tw
    assert blocks == min(total, sms * plan["per_sm"]) and plan["per_sm"] >= 1
    cover = torch.zeros((b, h, w), dtype=torch.int64)
    warp, lane = torch.arange(256) // 32, torch.arange(256) % 32
    for k in range(blocks):
        first, last = k * total // blocks, (k + 1) * total // blocks
        assert last > first
        for i in range(first, last):
            n, tile = divmod(i, ty * tx)
            r0, c0 = tile // tx * th, tile % tx * tw
            for j in range(plan["pixels"]):
                r, c = r0 + warp + 8 * j, c0 + lane
                keep = (r < h) & (c < w)
                cover[n].index_put_((r[keep], c[keep]),
                                    torch.ones(int(keep.sum()), dtype=torch.int64),
                                    accumulate=True)
    assert bool((cover == 1).all())


def test_motion_plan_refusals_and_budget():
    for shape in ((0, 8, 8, 3), (3, 0, 8, 3), (3, 8, 0, 3), (3, 8, 8, 2), (3, 2**29 + 1, 1, 1)):
        with pytest.raises(ValueError):
            km.motion_plan(*shape)
    with pytest.raises(ValueError):  # 2^31 tiles
        km.motion_plan(2**31 // 49 + 1, 224, 224, 3)
    # no batch limit of a grid's y: 70,000 images are one launch
    assert km.motion_plan(70000, 224, 224, 1)["total"] == 70000 * 49
    assert km.motion_plan(2, 224, 224, 3)["box_bytes"] == km.MOTION_BOX_BYTES
    # the reach sizes the budget, at most MOTION_BOX_BYTES; spans clamp to 2H, 2W
    sev5 = km.motion_plan(128, 224, 224, 3, km.tap_spans(20.0, 15.0, MOTION_BANK))
    assert sev5["box_bytes"] == 46 * 160 * 4  # rows of 52 · 3 floats, shifted, padded
    assert sev5["map"] == (46, 160)
    # two boxes a block: 3 blocks of 256 threads an SM at motion_blur's
    # severity 5, all 132 SMs' worth resident at once; 6 at snow's (registers)
    assert sev5["per_sm"] == 3 and sev5["grid"] == (396,)
    assert km.motion_plan(128, 224, 224, 1, (12, 16))["per_sm"] == 6
    assert km.motion_plan(2, 8, 8, 1, (40, 40))["box_bytes"] == 48 * 52 * 4  # 78 · 128
    shapes = ((224, 224, 3, (14, 20)), (40, 56, 1, (12, 16)), (8, 8, 3, (1, 1)))
    assert all(km.motion_plan(2, h, w, c, r)["box_bytes"] % 128 == 0 for h, w, c, r in shapes)
    # no reach, or one past the budget: no tensor box
    assert km.motion_plan(2, 224, 224, 3)["map"] == (0, 0)
    big = km.motion_plan(2, 224, 224, 3, (200, 200))
    assert big["map"] == (0, 0) and big["box_bytes"] == km.MOTION_BOX_BYTES
    # both boxes and the static arrays fit a block's 227 KB
    assert 2 * km.MOTION_BOX_BYTES + km.MOTION_BLOCK_BYTES <= 232_448


@pytest.mark.parametrize("name,severity,c,radius,sigma,bank", TAPS, ids=IDS)
def test_every_path_box_fits_the_budget(name, severity, c, radius, sigma, bank):
    """At 224², 40 × 56 and 8 × 8, every tile's box of every bank angle fits
    the plan's budget at the table's reach (so every path tile takes the box
    route), within MOTION_BOX_BYTES and a block's 227 KB."""
    dy, dx = (torch.from_numpy(a) for a in km.angle_tap_table(radius, sigma, bank)[:2])
    reach = km.tap_spans(radius, sigma, bank)
    for h, w in ((224, 224), (H, W), (8, 8)):
        plan = km.motion_plan(B, h, w, c, reach)
        assert plan["box_bytes"] <= km.MOTION_BOX_BYTES <= 227 * 1024
        most = 0
        for a in range(len(bank)):
            for r0 in range(0, h, plan["tile"][0]):
                for c0 in range(0, w, plan["tile"][1]):
                    _, _, bh, bw = km.tile_box(dy[a], dx[a], (r0, c0), h, w)
                    # the kernel's row: bw · C floats after a shift < 4, padded to 4
                    most = max(most, bh * ((bw * c + 6) // 4 * 4) * 4)
        assert most <= plan["box_bytes"]


@pytest.mark.parametrize("h,w", [(H, W), (8, 8)])
@pytest.mark.parametrize("name,severity,c,radius,sigma,bank", TAPS, ids=IDS)
def test_box_route_equals_plain_version(name, severity, c, radius, sigma, bank, h, w):
    """The box route, emulated, against ``motion_taps_reference`` under
    torch.equal: every tile boxed at the table's reach. The two images take
    mirrored bank angles, other ones at each severity (every angle's box is
    sized in ``test_every_path_box_fits_the_budget``)."""
    rng = np.random.default_rng(severity + 10 * c)
    img = torch.from_numpy(rng.random((B, h, w, c), dtype=np.float32))
    idx = torch.tensor([(7 * severity) % 32, 31 - (7 * severity) % 32])
    dy, dx, wt = km.tap_rows(idx, radius, sigma, bank)
    plan = km.motion_plan(B, h, w, c, km.tap_spans(radius, sigma, bank))
    got, routes = emulate(img, dy, dx, wt, plan["box_bytes"])
    assert routes == [B * plan["tiles"][0] * plan["tiles"][1], 0]
    assert torch.equal(got, km.motion_taps_reference(img, dy, dx, wt))


@pytest.mark.parametrize("c", [1, 3])
def test_gather_route_equals_plain_version(c):
    """A budget that sends some tiles to the gathering route (motion_blur's
    severity-5 rows at 40 × 56 with a budget that fits the box of the
    near-horizontal angle 16 and not those of ±45°), and far offsets that
    reach past the image and clamp to [-H, H] × [-W, W]: both routes, mixed
    in one batch, equal to the plain version."""
    rng = np.random.default_rng(c)
    img = torch.from_numpy(rng.random((3, H, W, c), dtype=np.float32))
    dy, dx, wt = km.tap_rows(torch.tensor([0, 16, 31]), 20.0, 15.0, MOTION_BANK)
    _, _, bh, bw = km.tile_box(dy[1], dx[1], (0, 0), H, W)
    got, routes = emulate(img, dy, dx, wt, bh * ((bw * c + 6) // 4 * 4) * 4)
    assert routes[0] > 0 and routes[1] > 0
    assert torch.equal(got, km.motion_taps_reference(img, dy, dx, wt))
    far_y = torch.from_numpy(rng.integers(-500, 500, (3, 9)).astype(np.int32))
    far_x = torch.from_numpy(rng.integers(-500, 500, (3, 9)).astype(np.int32))
    far_w = torch.from_numpy(rng.random((3, 9), dtype=np.float32))
    got, routes = emulate(img, far_y, far_x, far_w, km.MOTION_BOX_BYTES)
    assert routes[1] > 0
    assert torch.equal(got, km.motion_taps_reference(img, far_y, far_x, far_w))
