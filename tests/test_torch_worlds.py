"""Worlds of gloo ranks for the scale-out tests.

``spawn(scenario, tmp_path, world, inputs)`` starts ``world`` processes
with torch.multiprocessing's spawn start method (the pytest process runs
JAX threads, so it never forks), each initialising a gloo group through a
``file://`` store under ``tmp_path`` (so parallel test workers never share
a port), or none at all for ``world=0``: one process with no process
group. Each rank runs the scenario's function, which imports only torch,
numpy and horizonator_tpu_torch, and writes its outputs to an .npz; spawn
returns every rank's outputs as dicts. tests/test_torch_regions.py and
tests/test_torch_sharding.py hold them against the JAX package and the
port's single-device results. The module holds no test of its own.
"""

import math
import os

import numpy as np
import torch

CPD = 1200
W, H = 64, 32


def spawn(scenario: str, tmp_path, world: int, inputs: dict):
    import torch.multiprocessing as mp
    out = tmp_path / f"world_{scenario}"
    out.mkdir(exist_ok=True)
    init = tmp_path / f"init_{scenario}"
    try:
        mp.start_processes(_worker, args=(scenario, world, str(init),
                                          str(out), inputs),
                           nprocs=max(world, 1), start_method="spawn")
    except Exception as e:
        # a rank that raised leaves the others' collectives to abort:
        # report the traceback of the rank that raised
        errs = sorted(out.glob("*.err"))
        if errs:
            raise AssertionError(errs[0].read_text()) from e
        raise
    return [dict(np.load(out / f"{rank}.npz"))
            for rank in range(max(world, 1))]


def _worker(rank, scenario, world, init, out, inputs):
    import traceback
    import torch.distributed as dist
    torch.set_num_threads(1)
    if world:
        dist.init_process_group("gloo", init_method="file://" + init,
                                rank=rank, world_size=world)
    try:
        res = SCENARIOS[scenario](inputs)
    except Exception:
        with open(os.path.join(out, f"{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    np.savez(os.path.join(out, f"{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})


def params(vi, vj, vz, az0=-180.0, az1=180.0, zfar=9000.0, znear=100.0,
           lat=34.0):
    from horizonator_tpu_torch.render import make_params
    return make_params(
        device="cpu", viewer_cell_i=vi, viewer_cell_j=vj, viewer_z=vz,
        cos_viewer_lat=math.cos(math.radians(lat)),
        az_rad0=math.radians(az0), az_rad1=math.radians(az1), znear=znear,
        zfar=zfar, znear_color=znear, zfar_color=zfar)


def _np(*xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else x for x in xs]


def _regions(inputs):
    """The region entries on a 4-rank world: meshes of 4 bands, of 2 bands
    (twice, one per "az" coordinate, az_axis unused) and 2 bands x 2
    wedges; untextured, cell, packed-cell and half-cell colours, the
    crossing sampler, edge viewers, a grid padded to a band multiple."""
    from torch.distributed.device_mesh import DeviceMesh
    from horizonator_tpu_torch.parallel import (
        make_region_sharded_horizon, make_region_sharded_renderer)
    from horizonator_tpu_torch.parallel.mesh import coord, dim_size
    from horizonator_tpu_torch.parallel.regions import band_of
    from horizonator_tpu_torch.render.texture import ColorPlanes2x
    m4 = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("region",))
    m22 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                     mesh_dim_names=("region", "az"))
    res = {}
    for case in inputs["cases"]:
        name, mesh = case["name"], (m4 if case["mesh"] == 4 else m22)
        r, idx = dim_size(mesh, "region"), coord(mesh, "region")
        grid = inputs[case.get("grid", "dem")]
        n_valid = grid.shape[0]
        grid = np.pad(grid, ((0, -n_valid % r), (0, 0)))
        p = params(*case["view"], zfar=case["zfar"])
        kw = dict(width=W, k_cross=case["k"], cells_per_deg=CPD,
                  lat_hint_deg=34.0, sampler=case.get("sampler", "window"),
                  az_axis=case.get("az_axis"), n_valid_rows=n_valid)
        band = band_of(grid, idx, r, "cpu")
        if case.get("horizon"):
            fn = make_region_sharded_horizon(mesh, **kw)
            res[name + "/az"], res[name + "/tan"] = _np(*fn(band, p))
            continue
        form = case.get("colors")
        half = form is not None and form.startswith("half")
        fn = make_region_sharded_renderer(
            mesh, height=H, textured=form is not None,
            texture_scale=2 if half else 1, with_guard=True, **kw)
        if form is None:
            out = fn(band, p)
        else:
            s = 2 if half else 1
            planes = np.pad(inputs[form],
                            [(0, 0)] * (inputs[form].ndim - 2)
                            + [(0, s * (-n_valid % r)), (0, 0)])
            colors = band_of(planes, idx, r, "cpu", scale=s)
            if half:
                colors = ColorPlanes2x(colors)
            out = fn(band, colors, p)
        res[name + "/img"], res[name + "/rng"], res[name + "/guard"] = _np(
            *out)
    return res


def _sharding(inputs):
    """The batch x az entries, the API's region_mesh and render_batch(mesh=)
    and the viewshed ops' mesh= on a 4-rank world."""
    from torch.distributed.device_mesh import DeviceMesh
    from horizonator_tpu_torch import horizonator
    from horizonator_tpu_torch.ops import viewshed_count, viewshed_sweep
    from horizonator_tpu_torch.parallel import (make_sharded_horizon,
                                                make_sharded_renderer)
    from horizonator_tpu_torch.parallel.mesh import resolve_mesh
    from horizonator_tpu_torch.render import make_params
    m22 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                     mesh_dim_names=("batch", "az"))
    m4 = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("batch",))
    res = {}
    dem = torch.from_numpy(inputs["dem"])
    views = inputs["views"]
    p = make_params(device="cpu", **{
        k: [v[k] for v in views] for k in views[0]})
    k = inputs["k"]
    rkw = dict(width=W, height=H, nsteps=k, cells_per_deg=CPD,
               sampler="window", lat_hint_deg=34.0)
    for name, mesh in (("b2a2", m22), ("b4", m4)):
        mesh = resolve_mesh(mesh, ("batch", "az"), "cpu")
        fn = make_sharded_renderer(mesh, **rkw)
        res[f"{name}/img"], res[f"{name}/rng"], res[f"{name}/guard"] = _np(
            *fn(dem, p, with_dropped=True))
        fn = make_sharded_renderer(mesh, textured=True, **rkw)
        res[f"{name}/timg"], res[f"{name}/trng"] = _np(*fn(
            dem, p, color_planes=torch.from_numpy(inputs["cell"])))
    hz = make_sharded_horizon(resolve_mesh(m22, ("batch", "az"), "cpu"),
                              width=W, nsteps=256, cells_per_deg=CPD)
    res["hz/az"], res["hz/tan"] = _np(*hz(dem, p))

    api = inputs["api"]
    hr = horizonator(api["lat"], api["lon"], W, H, region_mesh="auto",
                     device="cpu", **api["kw"])
    res["api/region_r"] = hr._region["r"]
    res["api/img"], res["api/rng"] = hr.render(-60, 60, zfar=15000.0)
    res["api/pick"] = np.asarray(hr.pick(*api["pick"]), np.float64)
    res["api/haz"], res["api/htan"] = hr.horizon(-30, 30, width=32,
                                                 zfar=15000.0)
    res["api/bimg"], res["api/brng"] = hr.render_batch(
        -60, 60, api["lats"], api["lons"], zfar=15000.0)
    hs = horizonator(api["lat"], api["lon"], W, H, region_mesh=4,
                     hillshade=True, device="cpu", **api["kw"])
    res["api/himg"], res["api/hrng"] = hs.render(-60, 60, zfar=15000.0)
    h = horizonator(api["lat"], api["lon"], W, H, device="cpu", **api["kw"])
    for name, mesh in (("auto", "auto"), ("b2a2", m22), ("b4", m4)):
        res[f"api/m_{name}_img"], res[f"api/m_{name}_rng"] = h.render_batch(
            -60, 60, api["lats"], api["lons"], zfar=15000.0, mesh=mesh)

    vs = inputs["vs"]
    res["vs/sweep"] = viewshed_sweep(
        vs["dem"], vs["pts"], batch=8, mesh="auto", device="cpu",
        **vs["kw"]).numpy()
    res["vs/count"] = viewshed_count(
        vs["dem"], vs["pts"], batch=8, mesh=m4, device="cpu",
        **vs["ckw"]).numpy()
    try:
        viewshed_sweep(vs["dem"], vs["pts"], batch=6, mesh=m4,
                       device="cpu", **vs["kw"])
    except ValueError as e:
        res["vs/err_div"] = str(e)
    return res


def _solo(inputs):
    """One process and no process group: "auto" and 1 make a one-rank
    gloo group on a HashStore; a larger mesh raises naming torchrun; CUDA
    tensors never ride the gloo group."""
    import torch.distributed as dist
    from horizonator_tpu_torch import horizonator
    from horizonator_tpu_torch.ops import viewshed_count
    from horizonator_tpu_torch.parallel.mesh import resolve_mesh
    res = {}
    try:
        resolve_mesh(2, ("region",), "cpu")
    except ValueError as e:
        res["err_world"] = str(e)
    res["inited_after_err"] = dist.is_initialized()
    api = inputs["api"]
    hr = horizonator(api["lat"], api["lon"], W, H, region_mesh="auto",
                     device="cpu", render_texture=True, allow_downloads=False,
                     **api["tkw"])
    res["backend"] = str(dist.get_backend())
    res["world"] = dist.get_world_size()
    res["api/timg"], res["api/trng"] = hr.render(-60, 60, zfar=15000.0)
    try:
        resolve_mesh("auto", ("region",), "cuda")
    except ValueError as e:
        res["err_cuda"] = str(e)
    h = horizonator(api["lat"], api["lon"], W, H, device="cpu", **api["kw"])
    res["api/m_img"], res["api/m_rng"] = h.render_batch(
        -60, 60, api["lats"], api["lons"], zfar=15000.0, mesh="auto")
    vs = inputs["vs"]
    res["vs/count"] = viewshed_count(vs["dem"], vs["pts"], batch=8,
                                     mesh="auto", device="cpu",
                                     **vs["ckw"]).numpy()
    return res


SCENARIOS = {"regions": _regions, "sharding": _sharding, "solo": _solo}
