"""Port parity: region sharding (row bands) vs horizonator_tpu.

The banded window march runs on each band of a 128^2 grid (a band's rows
plus the next band's first row, the last band's halo a zero row), fed the
JAX geometry, against the JAX ``march_window(j_hi=, j_offset=)`` in
interpret mode, untextured and with cell (float and packed) and band-local
half-cell colours, at test_torch_window's tolerances: the far field
bitwise, tangents and colours included; the near band within 1e-5 (its
colours within one step of a channel at >= 99% bitwise). The bands' MAX
equals the port's own square march bitwise, and the masked MAX of their
colours the square march's colours wherever a sample is valid.

The region entries run in a spawned gloo world of 4 ranks
(tests/test_torch_worlds.py), each rank holding one band: meshes of 4
bands, of 2 bands and of 2 bands x 2 azimuth wedges, edge viewers, a grid
padded to a band multiple, every colour form and the crossing sampler. Every
rank returns the same result, which equals the port's single-device
render (and march) bitwise, and, on the wedge mesh, within the JAX
tests' wedge tolerance: sky masks disagree at < 0.2% of pixels, ranges
agree within 5e-3 relative + 1 m elsewhere (tests/test_regions.py:146).
Against the JAX region entries on the 8-virtual-device mesh the outputs
hold test_torch_render's tolerance (test_torch_textured's for colours).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from horizonator_tpu.parallel.regions import (
    make_region_sharded_horizon as j_region_horizon,
    make_region_sharded_renderer as j_region_renderer)
from horizonator_tpu.render import texture as jtex
from horizonator_tpu.render.crossing import crossing_geometry as j_geometry
from horizonator_tpu.render.window import march_window as j_march
from horizonator_tpu_torch.parallel.regions import (
    band_bounds, local_band, make_region_sharded_renderer)
from horizonator_tpu_torch.render import make_params, params_from_jax
from horizonator_tpu_torch.render import render_panorama
from horizonator_tpu_torch.render import texture as ttex
from horizonator_tpu_torch.render import window as twin
from horizonator_tpu_torch.render.crossing import (k_cross_for,
                                                   march_crossing,
                                                   pack_scene)
from tests import test_torch_worlds as torch_worlds
from tests.test_torch_geometry import (CPD, geo_to_torch, jax_params,
                                       make_dem, viewer_z)
from tests.test_torch_render import _compare
from tests.test_torch_textured import (_atlas_scene, _compare_textured,
                                       _near_tex_close)
from tests.test_torch_window import NEG, _near_band_close

N = 128
Q = twin.N_NEAR
W, H = torch_worlds.W, torch_worlds.H
ZFAR = 9000.0
K = k_cross_for(ZFAR, CPD, 34.0, n=N)
VIEWS = {"mid": (64.3, 63.6), "south": (64.3, 2.5), "north": (64.3, 125.4),
         "boundary": (64.0, 64.0)}


def _dem(n=N):
    return make_dem(n, rough=6.0)


def _view(name, dem):
    vi, vj = VIEWS[name]
    return vi, vj, viewer_z(dem, vi, vj)


def _planes(form, n, seed=9):
    """(JAX planes, port planes) of the whole grid: cell float, cell packed
    or half-cell."""
    rng = np.random.default_rng(seed)
    if form == "half":
        c = rng.integers(0, 256, (3, 2 * n, 2 * n)).astype(np.float32)
        cp = jtex.prepare_color_planes(jnp.asarray(c))
        return cp, ttex.scene_from_jax(cp, device="cpu")[0]
    c = rng.integers(0, 256, (3, n, n)).astype(np.float32)
    if form == "packed":
        pk = jtex.pack_cell_colors(jnp.asarray(c))
        return pk, ttex.scene_from_jax(pk, device="cpu")[0]
    return jnp.asarray(c), torch.from_numpy(c)


def _jax_band_planes(cp, idx, r):
    """The JAX band-local half-cell views (regions.py:112-131) of band idx:
    each view's band slice and its own next-band halo (zeros past the
    last band)."""
    n = cp.ns.shape[1]
    nb = n // r
    last = idx == r - 1

    def rows(x, lo, hi, k):
        halo = jnp.zeros_like(x[:k]) if last else x[hi:hi + k]
        return jnp.concatenate([x[lo:hi], halo], axis=0)
    ns = rows(cp.ns.T, idx * nb, (idx + 1) * nb, 1).T
    ew = rows(cp.ew, 2 * idx * nb, 2 * (idx + 1) * nb, 2)
    fp = rows(cp.full_packed, 2 * idx * nb, 2 * (idx + 1) * nb, 2)
    return jtex.ColorPlanes2x(ns=ns, ns_rev=ns[:, ::-1], ew=ew,
                              ew_rev=ew[:, ::-1], full_packed=fp)


@functools.partial(jax.jit, static_argnames=("width", "k"))
def _jax_band(dem, p, j_hi, j_off, cp, width, k):
    out = j_march(dem, p, width=width, k_cross=k, cells_per_deg=CPD,
                  lat_hint_deg=34.0, j_hi=j_hi, j_offset=j_off,
                  color_planes=cp)
    return out[0], out[2].dropped, out[2].truncated, (
        out[4] if cp is not None else None)


@functools.partial(jax.jit, static_argnames=("width",))
def _jax_geometry(p, width):
    return j_geometry(p, width=width, cells_per_deg=CPD)


@pytest.mark.parametrize("form,r,view", [
    (None, 2, "mid"), (None, 4, "mid"), (None, 4, "north"),
    (None, 4, "boundary"), ("cell", 4, "mid"), ("packed", 2, "mid"),
    ("half", 4, "mid"), ("half", 2, "south")])
def test_band_march_matches_jax(form, r, view):
    dem = _dem()
    vi, vj, vz = _view(view, dem)
    jp = jax_params(vi, vj, vz, zfar=ZFAR)
    tp = params_from_jax(jp, "cpu")
    geo = geo_to_torch(_jax_geometry(jp, W))
    jplanes, tplanes = _planes(form, N) if form else (None, None)
    nb = N // r
    parts, parts_tex = [], []
    for idx in range(r):
        j_off, j_hi = band_bounds(idx, r, nb)
        local = local_band(torch.from_numpy(dem), idx, r)
        tcp = jcp = None
        if form == "half":
            tcp = local_band(tplanes, idx, r)
            jcp = _jax_band_planes(jplanes, idx, r)
        elif form:
            tcp = local_band(tplanes, idx, r)
            jcp = jnp.asarray(tcp.numpy())
        jt, jd, jtr, jx = _jax_band(jnp.asarray(local.numpy()), jp,
                                    jnp.float32(j_hi), jnp.int32(j_off), jcp,
                                    W, K)
        out = twin.march_from_geometry(
            local, tp, geo, k_cross=K, cells_per_deg=CPD, lat_hint_deg=34.0,
            j_hi=j_hi, j_offset=j_off, color_planes=tcp)
        tt, dists = out[0].numpy(), out[1]
        jt = np.asarray(jt)
        assert int(jd) == 0 and int(jtr) == 0
        assert (int(dists.dropped), int(dists.truncated)) == (0, 0)
        assert tt.shape == jt.shape
        np.testing.assert_array_equal(tt[:, Q:], jt[:, Q:])
        _near_band_close(tt[:, :Q], jt[:, :Q], min_bitwise=0.95)
        if form:
            tx, jx = out[2].numpy(), np.asarray(jx)
            np.testing.assert_array_equal(tx[:, Q:], jx[:, Q:])
            near = jt[:, :Q] > NEG
            if near.any():
                _near_tex_close(tx[:, :Q], jx[:, :Q], near)
            parts_tex.append(np.where(tt > NEG, tx, -1))
        parts.append(tt)
        assert (tt > NEG).any()
    # the bands' MAX is the square march, bitwise (colours where valid)
    sq = twin.march_from_geometry(torch.from_numpy(dem), tp, geo, k_cross=K,
                                  cells_per_deg=CPD, lat_hint_deg=34.0,
                                  color_planes=tplanes)
    comb = np.max(parts, axis=0)
    np.testing.assert_array_equal(comb, sq[0].numpy())
    if form:
        valid = comb > NEG
        np.testing.assert_array_equal(np.max(parts_tex, axis=0)[valid],
                                      sq[2].numpy()[valid])


def test_band_planes_checked_on_both_dims():
    """A band's colour plane whose rows match and whose columns do not
    raises in every form (the JAX package's band check reads the rows
    alone, window.py:705, and never reads a half-cell band's full plane's
    shape)."""
    dem = _dem()
    local = local_band(torch.from_numpy(dem), 1, 4)
    nj = local.shape[0]
    tp = params_from_jax(jax_params(*_view("mid", dem), zfar=ZFAR), "cpu")
    kw = dict(width=W, k_cross=K, cells_per_deg=CPD, j_hi=float(nj - 1),
              j_offset=32)
    for bad in (torch.zeros(nj, N - 2, dtype=torch.int32),
                torch.zeros(3, nj, N - 2),
                torch.zeros(3, 2 * nj, 2 * N - 2),
                ttex.ColorPlanes2x(torch.zeros(2 * nj, 2 * N - 2,
                                               dtype=torch.int32))):
        with pytest.raises(ValueError, match="does not match|neither"):
            twin.march_window(local, tp, color_planes=bad, **kw)
    out = twin.march_window(local, tp, color_planes=torch.zeros(
        nj, N, dtype=torch.int32), **kw)
    assert out[4].shape == out[0].shape


def test_hybrid_band_locals_bitwise_single():
    """The hybrid near field on bands (the atlas replicated, positions
    global): every rank's local march of R = 4 driven in one process,
    combined as the collectives combine them, renders bitwise the
    single-device hybrid render."""
    dem = _dem()
    vi, vj, vz = _view("mid", dem)
    p = make_params(device="cpu", viewer_cell_i=vi, viewer_cell_j=vj,
                    viewer_z=vz, cos_viewer_lat=np.cos(np.radians(34.0)),
                    az_rad0=-np.pi, az_rad1=np.pi, znear=100.0, zfar=ZFAR,
                    znear_color=100.0, zfar_color=ZFAR)
    _, cp = _planes("half", N, seed=5)
    atlas, ap = _atlas_scene(N, vi, vj, seed=5)
    hyb = dict(atlas_params=ttex.AtlasParams(*ap), exact_near_m=1500.0)
    atlas = torch.from_numpy(atlas)
    img1, rng1 = render_panorama(
        torch.from_numpy(dem), p, width=W, height=H, nsteps=K,
        cells_per_deg=CPD, lat_hint_deg=34.0, textured=True, color_planes=cp,
        atlas=atlas, **hyb)
    for shape in ({"region": 4}, {"region": 2, "az": 2}):
        fn = make_region_sharded_renderer(
            shape, width=W, height=H, k_cross=K, cells_per_deg=CPD,
            lat_hint_deg=34.0, textured=True, texture_scale=2,
            az_axis="az" if "az" in shape else None, **hyb)
        r, wedges = shape["region"], []
        for a in range(shape.get("az", 1)):
            parts = [fn.local(i, a, local_band(torch.from_numpy(dem), i, r),
                              p, local_band(cp, i, r), atlas)
                     for i in range(r)]
            wedges.append(fn.resolve(*fn.combine(parts), parts[0]))
        img2, rng2 = (torch.cat(xs, dim=1) for xs in zip(*wedges))
        if len(wedges) == 1:
            assert torch.equal(img1, img2) and torch.equal(rng1, rng2)
        else:
            _wedge_close(rng1.numpy(), rng2.numpy())


def _wedge_close(r_1, r_s):
    """The JAX tests' wedge tolerance (tests/test_regions.py:146-152)."""
    agree = (r_s > 0) == (r_1 > 0)
    assert (~agree).mean() < 0.002
    np.testing.assert_allclose(r_s[agree], r_1[agree], rtol=5e-3, atol=1.0)


# -- the region entries in a gloo world -------------------------------------

CASES = [dict(name="r4", mesh=4, view="mid"),
         dict(name="r4_south", mesh=4, view="south"),
         dict(name="r4_north", mesh=4, view="north"),
         dict(name="r4_boundary", mesh=4, view="boundary"),
         dict(name="r4_cell", mesh=4, view="mid", colors="cell"),
         dict(name="r4_packed", mesh=4, view="north", colors="packed"),
         dict(name="r4_half", mesh=4, view="mid", colors="half"),
         dict(name="r4_half_north", mesh=4, view="north", colors="half"),
         dict(name="r2", mesh=22, view="mid"),
         dict(name="r2_half", mesh=22, view="south", colors="half"),
         dict(name="r2a2", mesh=22, view="mid", az_axis="az"),
         dict(name="r2a2_cell", mesh=22, view="mid", az_axis="az",
              colors="cell"),
         dict(name="r4_crossing", mesh=4, view="mid", sampler="crossing"),
         dict(name="r4_pad", mesh=4, view="north", grid="dem126"),
         dict(name="r4_pad_half", mesh=4, view="mid", grid="dem126",
              colors="half126"),
         dict(name="h_r4", mesh=4, view="mid", horizon=True),
         dict(name="h_r4_north", mesh=4, view="north", horizon=True),
         dict(name="h_r4_crossing", mesh=4, view="mid", horizon=True,
              sampler="crossing"),
         dict(name="h_r2a2", mesh=22, view="mid", horizon=True,
              az_axis="az")]


def _inputs():
    dem = _dem()
    dem126 = np.ascontiguousarray(make_dem(126, rough=6.0))
    inputs = dict(dem=dem, dem126=dem126, cases=[])
    for form in ("cell", "packed", "half"):
        inputs[form] = _planes(form, N)[1]
        inputs[form] = _rows_np(inputs[form])
    inputs["half126"] = _rows_np(_planes("half", 126, seed=3)[1])
    for c in CASES:
        grid = inputs[c.get("grid", "dem")]
        vi, vj, vz = _view(c["view"], grid)
        if grid.shape[0] == 126:
            vj = min(vj, 123.4)
            vz = viewer_z(grid, vi, vj)
        inputs["cases"].append(dict(c, view=(vi, vj, vz), zfar=ZFAR,
                                    k=k_cross_for(ZFAR, CPD, 34.0,
                                                  n=grid.shape[0])))
    return inputs


def _rows_np(planes):
    """A port colour plane as numpy rows: a half-cell plane's packed rows."""
    if isinstance(planes, ttex.ColorPlanes2x):
        planes = planes.full_packed
    return planes.numpy()


@pytest.fixture(scope="module")
def regions_world(tmp_path_factory):
    inputs = _inputs()
    outs = torch_worlds.spawn("regions", tmp_path_factory.mktemp("regions"),
                              4, inputs)
    # every rank returns the whole result
    for other in outs[1:]:
        assert other.keys() == outs[0].keys()
        for k, v in outs[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    return inputs, outs[0]


def _single(inputs, case):
    """The port's single-device render (or march's horizon) of a case."""
    grid = inputs[case.get("grid", "dem")]
    vi, vj, vz = case["view"]
    p = torch_worlds.params(vi, vj, vz, zfar=case["zfar"])
    dem = torch.from_numpy(grid)
    form = case.get("colors")
    cp = None
    if form:
        cp = torch.from_numpy(inputs[form])
        if form.startswith("half"):
            cp = ttex.ColorPlanes2x(cp)
    sampler = case.get("sampler", "window")
    if case.get("horizon"):
        if sampler == "crossing":
            tanel, _, _, az = march_crossing(pack_scene(dem), p, width=W,
                                             k_cross=case["k"],
                                             cells_per_deg=CPD)
        else:
            tanel, _, _, az = twin.march_window(
                dem, p, width=W, k_cross=case["k"], cells_per_deg=CPD,
                lat_hint_deg=34.0)
        return az.numpy(), tanel.amax(dim=-1).numpy()
    img, rng, guard = render_panorama(
        dem, p, width=W, height=H, nsteps=case["k"], cells_per_deg=CPD,
        lat_hint_deg=34.0, sampler=sampler, textured=cp is not None,
        color_planes=cp, with_dropped=True)
    return img.numpy(), rng.numpy(), guard.numpy()


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_region_entries_bitwise_single(regions_world, name):
    inputs, out = regions_world
    case = next(c for c in inputs["cases"] if c["name"] == name)
    ref = _single(inputs, case)
    if case.get("horizon"):
        az, tan = out[name + "/az"], out[name + "/tan"]
        if case.get("az_axis"):
            np.testing.assert_allclose(az, ref[0], atol=1e-5)
            assert ((tan > NEG) == (ref[1] > NEG)).all()
            vis = ref[1] > NEG
            np.testing.assert_allclose(tan[vis], ref[1][vis], rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(az, ref[0])
            np.testing.assert_array_equal(tan, ref[1])
        return
    img, rng, guard = (out[name + s] for s in ("/img", "/rng", "/guard"))
    assert guard.tolist() == [0, 0]
    assert (rng > 0).mean() > 0.05 and (rng < 0).mean() > 0.05
    if case.get("az_axis"):
        _wedge_close(ref[1], rng)
        assert img.shape == ref[0].shape
    else:
        np.testing.assert_array_equal(img, ref[0])
        np.testing.assert_array_equal(rng, ref[1])


def _jmesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names)


@pytest.mark.parametrize("name", ["r4", "r4_half", "r2a2", "h_r4",
                                  "r4_pad"])
def test_region_entries_match_jax(regions_world, name):
    """The world's outputs against the JAX region entries on the virtual
    mesh, at test_torch_render's (test_torch_textured's) tolerance."""
    inputs, out = regions_world
    case = next(c for c in inputs["cases"] if c["name"] == name)
    grid = inputs[case.get("grid", "dem")]
    n_valid = grid.shape[0]
    r = 4 if case["mesh"] == 4 else 2
    names = ("region", "az") if case.get("az_axis") else ("region",)
    mesh = _jmesh((r, 2) if case.get("az_axis") else (r,), names)
    jp = jax_params(*case["view"], zfar=ZFAR)
    gpad = jnp.asarray(np.pad(grid, ((0, -n_valid % r), (0, 0))))
    kw = dict(width=W, k_cross=case["k"], cells_per_deg=CPD,
              lat_hint_deg=34.0, az_axis=case.get("az_axis"),
              n_valid_rows=n_valid)
    if case.get("horizon"):
        _, tan_j = j_region_horizon(mesh, **kw)(gpad, jp)
        tan_j, tan_t = np.asarray(tan_j), out[name + "/tan"]
        assert ((tan_j > NEG) == (tan_t > NEG)).all()
        np.testing.assert_allclose(tan_t, tan_j, atol=1e-5)
        return
    form = case.get("colors")
    if form:
        cp = _planes("half", N)[0]
        fn = j_region_renderer(mesh, height=H, textured=True,
                               texture_scale=2, **kw)
        img_j, rng_j = fn(gpad, (cp.ns, cp.ew, cp.full_packed), jp)
        _compare_textured(np.asarray(img_j), np.asarray(rng_j),
                          out[name + "/img"], out[name + "/rng"])
    else:
        img_j, rng_j = j_region_renderer(mesh, height=H, **kw)(gpad, jp)
        _compare(np.asarray(img_j), np.asarray(rng_j), out[name + "/img"],
                 out[name + "/rng"])
