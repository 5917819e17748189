"""The LOD render on the card at the srtm1-lod benchmark cell's sizes,
bitwise against its plain PyTorch version (``plain=True``, the same card
tensors): a 5000^2 SRTM1 grid, zfar 40 km at 4096 x 1024 over 360
degrees, whose plan has three bands (k_len 655, 451 and 195: a field of
1305 samples a column); the image, the ranges and the coverage guard, one
window-march launch a level and one near-band launch. Skips without a
card. The module imports no JAX, so it runs on a machine with a card and
without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_lod_card.py
"""

import math

import numpy as np
import pytest
import torch

from horizonator_tpu_torch.kernels import near_band, window_march
from horizonator_tpu_torch.render import lod, make_params, render_panorama

pytestmark = pytest.mark.card
CPD, LAT, N = 3600, 34.29, 5000
W, H, ZFAR = 4096, 1024, 40000.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def relief(n: int, seed: int = 11) -> np.ndarray:
    """Hills of srtm3-40km's size in metres at SRTM1's cells, with 10 m
    of noise, rounded to whole metres."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32) / 3,
                         np.arange(n, dtype=np.float32) / 3, indexing="ij")
    z = (600 + 500 * np.sin(ii / 223) * np.cos(jj / 181)
         + 200 * np.sin(ii / 37 + 1.3) * np.cos(jj / 53)
         + 10 * rng.standard_normal(ii.shape, dtype=np.float32))
    return np.round(np.maximum(z, 0)).astype(np.float32)


def test_lod_render_bitwise_plain(card):
    dem = torch.from_numpy(relief(N)).to(card)
    plan = lod.lod_plan(ZFAR, W, CPD, 35.0, N)
    assert [s.k_len for s in plan] == [655, 451, 195]
    pyr = lod.build_pyramid(dem, len(plan))
    vi, vj = 2731.37, 2498.81
    p = make_params(device=card, viewer_cell_i=vi, viewer_cell_j=vj,
                    viewer_z=float(dem[int(vj), int(vi)]) + 1.0,
                    cos_viewer_lat=math.cos(math.radians(LAT)),
                    az_rad0=-math.pi, az_rad1=math.pi, znear=100.0,
                    zfar=ZFAR, znear_color=100.0, zfar_color=ZFAR)
    kw = dict(width=W, height=H, nsteps=1600, cells_per_deg=CPD,
              sampler="lod", lat_hint_deg=30.0, lod_plan=plan,
              znear_hint_m=128.0, with_dropped=True)
    marches, nears = window_march.march.launches, near_band.near_band.launches
    img, rng, guard = render_panorama(pyr, p, **kw)
    assert window_march.march.launches - marches == len(plan)
    assert near_band.near_band.launches - nears == 1
    img_p, rng_p, guard_p = render_panorama(pyr, p, plain=True, **kw)
    torch.cuda.synchronize()
    assert img.shape == (H, W, 3) and rng.shape == (H, W)
    assert torch.equal(img, img_p), int((img != img_p).any(-1).sum())
    assert torch.equal(rng, rng_p), int((rng != rng_p).sum())
    assert guard.tolist() == guard_p.tolist() == [0, 0]
    far = (rng > 0) & (img[..., 2] > 255 * (plan[1].d_lo - 100.0) / ZFAR)
    print(f"{torch.cuda.get_device_name(card)}: sky "
          f"{float((rng < 0).float().mean()):.3f}, pixels beyond "
          f"{plan[1].d_lo:.0f} m {int(far.sum())}")
