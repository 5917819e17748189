"""GPU smoke test of horizonator_tpu_torch: build, check and time its kernels,
then drive the main render path and the API on the card.

    python3 chip_smoke.py                 # one CUDA card; exit 0 = all pass
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table
                                          # of the render into DIR

Phases, in order; any failure raises and exits nonzero:
 1. build both CUDA kernels from csrc/ (nvcc, sm_90a) and print the card;
 2. window-march kernel vs its plain version at the bench shape (3400^2
    DEM of bench.py's formula, seed 7, 4096 columns, 360 deg, zfar 40 km):
    tangents bitwise equal, no dropped or truncated samples;
 3. resolve kernel vs its plain version on those rows at H 1024: idx, ok
    and alpha bitwise equal;
 4. planar-DEM analytic oracle through the march on the card (max tangent
    error <= 4e-3: catches precision loss that correlated checks cannot);
 5. the main path, render_panorama at 4096x1024 on that scene: visible
    fraction in (0.05, 0.95), both kernels launched, output bitwise equal
    to the plain versions' render; median ms/viewpoint over 20 renders
    (CUDA events) with kernels and with plain versions, and each step's
    time;
 6. the API: horizonator(lat, lon, 4096, 1024, dir_dems=<3x3 synthetic
    SRTM3 tiles>).render(-180, 180) at the default radius and zfar.
The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W, H = 4096, 1024
LAT = 34.3
ZFAR = 40000.0
CPD = 1200
N = 3400
RENDERS = 20


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def log(*a):
    print(*a, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def bench_dem(seed=7, n=N):
    """bench.py's synthetic 3x3-SRTM3-sized DEM."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (600.0
         + 500.0 * np.sin(ii / 223.0) * np.cos(jj / 181.0)
         + 200.0 * np.sin(ii / 37.0 + 1.3) * np.cos(jj / 53.0)
         + 30.0 * rng.standard_normal((n, n), dtype=np.float32))
    return np.maximum(z, 0.0).astype(np.float32)


def cuda_ms(fn, n, warmup=2):
    """Median device time of fn() over n calls, CUDA events around each."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(i)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def cuda_ms_run(fn, n, warmup=2):
    """Mean device time of fn() over a run of n back-to-back calls between
    two CUDA events (a kernel's own time, without per-call host gaps)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(n):
        fn(i)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def write_tiles(d, lat0, lon0):
    """3x3 synthetic SRTM3 tiles around (lat0, lon0): ridges and peaks."""
    from horizonator_tpu_torch.dem import hgt
    edge = hgt.SRTM3_EDGE
    for tl in range(lat0 - 1, lat0 + 2):
        for tn in range(lon0 - 1, lon0 + 2):
            la = (tl + 1.0 - np.arange(edge) / (edge - 1))[:, None]
            lo = (tn + np.arange(edge) / (edge - 1))[None, :]
            z = (700.0 + 600.0 * np.sin(lo * 9.1) * np.cos(la * 7.3)
                 + 250.0 * np.sin(lo * 41.0 + 0.7) * np.cos(la * 37.0)
                 + 1500.0 * np.exp(-((la - lat0 - 0.62) ** 2
                                     + (lo - lon0 - 0.35) ** 2) / 0.004))
            hgt.write_hgt(os.path.join(d, hgt.hgt_filename(tl, tn)),
                          np.round(np.maximum(z, 0.0)).astype(np.int16))


def main(profile_dir=None):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from horizonator_tpu_torch import horizonator
    from horizonator_tpu_torch.kernels import build
    from horizonator_tpu_torch.kernels.resolve import resolve, resolve_plain
    from horizonator_tpu_torch.kernels.window_march import march, march_plain
    from horizonator_tpu_torch.render import make_params, render_panorama
    from horizonator_tpu_torch.render.crossing import (N_NEAR,
                                                       crossing_geometry,
                                                       k_cross_for)
    from horizonator_tpu_torch.render.raymarch import (horizon_rows,
                                                       resolve_to_image)
    from horizonator_tpu_torch.render.resolve_window import (alpha_quantum,
                                                             resolve_window)
    from horizonator_tpu_torch.render.window import (march_from_geometry,
                                                     march_window)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    path, nvcc_s, nvcc_log = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    log(f"[1] kernels built in {build_s:.2f} s (nvcc {nvcc_s:.2f} s): "
        f"{path.name}")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"    ptxas: {line.strip()}")

    # -- 2. window march: kernel vs plain at the bench shape ---------------
    dem = torch.from_numpy(bench_dem()).to(dev)
    k = k_cross_for(ZFAR, CPD, LAT, n=N)

    def bench_params(i=0):
        return make_params(
            device=dev, viewer_cell_i=N / 2 + i, viewer_cell_j=N / 2 - i,
            viewer_z=900.0, cos_viewer_lat=math.cos(math.radians(LAT)),
            az_rad0=math.radians(-180.0), az_rad1=math.radians(180.0),
            znear=100.0, zfar=ZFAR, znear_color=100.0, zfar_color=ZFAR)

    p = bench_params()
    geo = crossing_geometry(p, width=W, cells_per_deg=CPD)
    mkw = dict(k_cross=k, cells_per_deg=CPD, lat_hint_deg=LAT)
    tan_k, dists = march_from_geometry(dem, p, geo, **mkw)
    tan_p, dists_p = march_from_geometry(dem, p, geo, plain=True, **mkw)
    torch.cuda.synchronize()
    guard = [int(dists.dropped), int(dists.truncated)]
    if guard != [0, 0] or [int(dists_p.dropped), int(dists_p.truncated)] \
            != [0, 0]:
        fail(f"march guards {guard}")
    if not torch.equal(tan_k, tan_p):
        fail(f"window march != plain: {int((tan_k != tan_p).sum())} samples "
             f"differ, max {max_abs(tan_k, tan_p)}")
    march_err = max_abs(tan_k[:, N_NEAR:], tan_p[:, N_NEAR:])
    log(f"[2] window march {tuple(tan_k.shape)} (k={k}): kernel == plain "
        f"bitwise; dropped=truncated=0")

    # -- 3. resolve: kernel vs plain on those rows ---------------------------
    y_k = horizon_rows(tan_k, p, width=W, height=H).contiguous()
    amax, int_first = alpha_quantum(y_k.shape[1], H)
    out_k = resolve_window(y_k, H)
    out_p = resolve_window(y_k, H, plain=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("idx", "alpha", "ok"), out_k, out_p):
        if not torch.equal(a, b):
            fail(f"resolve {name} != plain: {int((a != b).sum())} differ")
    resolve_err = max(max_abs(out_k[0], out_p[0]), max_abs(out_k[1], out_p[1]))
    log(f"[3] resolve {tuple(y_k.shape)} -> H={H} (amax {amax:g}): kernel "
        f"== plain bitwise (idx, alpha, ok)")

    # -- 4. planar-DEM analytic oracle ----------------------------------------
    n4 = 512
    jj, ii = np.meshgrid(np.arange(n4, dtype=np.float32),
                         np.arange(n4, dtype=np.float32), indexing="ij")
    z0, a_sl, b_sl, dz0 = 1200.0, 0.6, -0.35, 25.0
    dem4 = torch.from_numpy((z0 + a_sl * ii + b_sl * jj).astype(
        np.float32)).to(dev)
    p4 = make_params(device=dev, viewer_cell_i=255.3, viewer_cell_j=257.6,
                     viewer_z=z0 + a_sl * 255.3 + b_sl * 257.6 + dz0,
                     cos_viewer_lat=math.cos(math.radians(34.0)),
                     az_rad0=math.radians(-180.0),
                     az_rad1=math.radians(180.0), znear=100.0, zfar=6000.0,
                     znear_color=100.0, zfar_color=6000.0)
    tan4, _, d4, az4 = march_window(
        dem4, p4, width=512, k_cross=k_cross_for(6000.0, CPD, 34.0, n=n4),
        cells_per_deg=CPD, lat_hint_deg=34.0)
    idx4 = torch.arange(tan4.shape[1], device=dev).expand(512, -1)
    d_np = d4.d_of(idx4).cpu().numpy().astype(np.float64)
    t_np = tan4.cpu().numpy().astype(np.float64)
    az_np = az4.cpu().numpy().astype(np.float64)
    cell_n = 6371000.0 * math.pi / 180.0 / CPD
    cell_e = cell_n * math.cos(math.radians(34.0))
    g = a_sl * np.sin(az_np) / cell_e + b_sl * np.cos(az_np) / cell_n
    valid = (t_np > -1e30) & (d_np >= 100.0)
    err4 = float(np.abs((t_np - (g[:, None] - dz0 / np.maximum(d_np, 1.0)))
                        * valid).max())
    if not valid.sum() or err4 > 4e-3:
        fail(f"planar-DEM oracle error {err4} (budget 4e-3)")
    log(f"[4] planar-DEM analytic oracle: max tangent error {err4:.3e} "
        f"over {int(valid.sum())} samples (budget 4e-3)")

    # -- 5. main path -----------------------------------------------------
    rkw = dict(width=W, height=H, nsteps=k, cells_per_deg=CPD,
               lat_hint_deg=LAT)
    march.launches = resolve.launches = 0
    img, rng, guard = render_panorama(dem, p, with_dropped=True, **rkw)
    torch.cuda.synchronize()
    launches = {"window_march": march.launches, "resolve": resolve.launches}
    if min(launches.values()) < 1:
        fail(f"main path skipped a kernel: {launches}")
    vis = float((rng > 0).float().mean())
    if not 0.05 < vis < 0.95:
        fail(f"degenerate visible fraction {vis}")
    if img.shape != (H, W, 3) or img.dtype != torch.uint8 \
            or rng.shape != (H, W) or guard.tolist() != [0, 0]:
        fail(f"bad render output {img.shape} {img.dtype} {rng.shape} "
             f"{guard.tolist()}")
    img_p, rng_p = render_panorama(dem, p, plain=True, **rkw)
    if not (torch.equal(img, img_p) and torch.equal(rng, rng_p)):
        fail("kernel render != plain render")
    log(f"[5] render {W}x{H}: visible {vis:.4f}, launches {launches}, "
        f"image and ranges == plain-version render bitwise")

    params = [bench_params(i) for i in range(RENDERS + 2)]
    ms_kernel = cuda_ms(lambda i: render_panorama(dem, params[i], **rkw),
                        RENDERS)
    ms_plain = cuda_ms(lambda i: render_panorama(dem, params[i], plain=True,
                                                 **rkw), RENDERS)
    run_kernel = cuda_ms_run(
        lambda i: render_panorama(dem, params[i], **rkw), RENDERS)
    log(f"[5] ms/viewpoint (median of {RENDERS}, CUDA events): kernels "
        f"{ms_kernel:.3f}, plain versions {ms_plain:.3f}; back-to-back "
        f"run of {RENDERS} with kernels: {run_kernel:.3f} ms each")

    # each kernel alone vs its plain version, at the main path's shapes
    pcol = torch.stack([geo.a, geo.t, geo.e, geo.scale,
                        geo.axis0.float(), geo.sign.float(),
                        geo.j_dom.float(), torch.zeros_like(geo.a)],
                       1).contiguous()
    fscal = torch.stack([p.viewer_z, p.znear, p.zfar, p.curv])
    k_lim = tan_k.shape[1] - N_NEAR
    t_march = cuda_ms_run(lambda i: march(dem, pcol, fscal, k_lim), 200)
    t_march_p = cuda_ms_run(lambda i: march_plain(dem, pcol, fscal, k_lim),
                            50)
    t_res = cuda_ms_run(lambda i: resolve(y_k, H, amax, int_first), 200)
    t_res_p = cuda_ms_run(lambda i: resolve_plain(y_k, H, amax, int_first),
                          50)
    log(f"[5] window march kernel {t_march:.4f} ms vs plain {t_march_p:.4f}; "
        f"resolve kernel {t_res:.4f} ms vs plain {t_res_p:.4f} (mean over "
        f"back-to-back runs)")

    # where the frame's time goes, step by step (kernel path)
    steps = {
        "geometry": lambda i: crossing_geometry(p, width=W, cells_per_deg=CPD),
        "march (kernel + near band + guards)":
            lambda i: march_from_geometry(dem, p, geo, **mkw),
        "row map (atan)":
            lambda i: horizon_rows(tan_k, p, width=W, height=H),
        "resolve + tail (resolve_to_image)":
            lambda i: resolve_to_image(tan_k, dists.d_of, geo.az, p,
                                       width=W, height=H),
    }
    for name, fn in steps.items():
        log(f"[5] step {name}: {cuda_ms(fn, 20):.4f} ms")

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile as tprof
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for i in range(5):
                render_panorama(dem, params[i], **rkw)
            torch.cuda.synchronize()
        events = prof.key_averages()
        table = events.table(sort_by="self_cuda_time_total", row_limit=100)
        busy = sum(e.self_device_time_total for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   ) / 1e3 / 5
        os.makedirs(profile_dir, exist_ok=True)
        out = os.path.join(profile_dir, "profile_render.txt")
        with open(out, "w") as f:
            f.write(f"{card}\n5 renders {W}x{H}\n{table}\n")
        log(f"[5] profile: device busy {busy:.3f} ms per render of "
            f"{ms_kernel:.3f} ms ({100 * busy / ms_kernel:.1f}%); table in "
            f"{out}")

    # -- 6. the API -------------------------------------------------------
    with tempfile.TemporaryDirectory() as tiles:
        write_tiles(tiles, 34, -118)
        h = horizonator(34.4, -117.6, W, H, dir_dems=tiles)
        march.launches = resolve.launches = 0
        img6, rng6 = h.render(-180, 180)
        api_launches = {"window_march": march.launches,
                        "resolve": resolve.launches}
    if min(api_launches.values()) < 1:
        fail(f"API render skipped a kernel: {api_launches}")
    if img6.shape != (H, W, 3) or img6.dtype != np.uint8 \
            or rng6.shape != (H, W) or rng6.dtype != np.float32:
        fail(f"bad API output {img6.shape} {img6.dtype} {rng6.shape}")
    vis6 = float((rng6 > 0).mean())
    if not 0.05 < vis6 < 0.95:
        fail(f"degenerate API visible fraction {vis6}")
    log(f"[6] API render {W}x{H} of {h.mosaic.grid.shape} grid: visible "
        f"{vis6:.4f}, launches {api_launches}")

    kernels = [
        {"name": "window_march", "route": "cuda",
         "source": "horizonator_tpu_torch/kernels/csrc/window_march.cu",
         "replaces": "horizonator_tpu/render/window.py:446",
         "launches": launches["window_march"], "max_abs_err": march_err,
         "ms": t_march, "plain_ms": t_march_p},
        {"name": "resolve", "route": "cuda",
         "source": "horizonator_tpu_torch/kernels/csrc/resolve.cu",
         "replaces": "horizonator_tpu/render/resolve_window.py:117",
         "launches": launches["resolve"], "max_abs_err": resolve_err,
         "ms": t_res, "plain_ms": t_res_p},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(profile_dir=args[args.index("--profile") + 1]
                  if "--profile" in args else None))
