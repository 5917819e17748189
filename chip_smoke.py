"""GPU smoke test of horizonator_tpu_torch: build, check and time its kernels,
then drive the main render path and the API on the card.

    python3 chip_smoke.py                 # one CUDA card; exit 0 = all pass
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table
                                          # of the render into DIR
    python3 chip_smoke.py --time-march ROOT TAG
        # only: time the march entries of the package under the tree ROOT
        # at the bench shape, the square ones and the banded ones on phase
        # 33's 4 bands (64-launch graphs, median of 7), where the tree's
        # entries take out= each also into lanes [4, 4 + k) of a field,
        # and print ptxas's lines for every instance; run twice per tree
        # (parent, change, change, parent) to compare two trees in one
        # call
    python3 chip_smoke.py --time-shadows ROOT TAG
        # only: time shadow_light of the package under the tree ROOT over
        # the bench DEM at phase 26's suns (median of 5 each), the same
        # way round
    python3 chip_smoke.py --oracle        # only: build, then phases 29-31
    python3 chip_smoke.py --front         # only: build, then phases 32
                                          # and 34
    python3 chip_smoke.py --scale-out     # only: build, then phase 33

Phases, in order; any failure raises and exits nonzero:
 1. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the card;
 2. window-march kernel vs its plain version at the bench shape (3400^2
    DEM of bench.py's formula, seed 7, 4096 columns, 360 deg, zfar 40 km):
    tangents bitwise equal, no dropped or truncated samples; the near
    band's kernel (kernels/csrc/near_band.cu) at that shape bitwise equal
    to near_band_plain (tangents, near_hi, dropped, dq, iq, jq), its
    device ms (graph replay) against its bound and the plain version's;
 3. resolve kernel vs its plain version on those rows at H 1024: idx, ok
    and alpha bitwise equal;
 4. planar-DEM analytic oracle through the march on the card (max tangent
    error <= 4e-3: catches precision loss that correlated checks cannot);
 5. the main path, render_panorama at 4096x1024 on that scene: visible
    fraction in (0.05, 0.95), both kernels launched, output bitwise equal
    to the plain versions' render; median ms/viewpoint over 20 renders
    (CUDA events) with kernels and with plain versions, each step's
    time, and the march kernel's time at five step counts; suite config
    2's annotation range queries (512 POIs x a 12-row fuzz, one gather
    on the ranges, benchmarks/suite.py:110-114) against numpy's gather of
    the host copy, timed with the render;
 6. the API: horizonator(lat, lon, 4096, 1024, dir_dems=<3x3 synthetic
    SRTM3 tiles>).render(-180, 180) at the default radius and zfar;
 7. textured window march vs its plain version on phase 2's scene, with
    seeded (3, 6800, 6800) half-cell colors packed on the card, then with
    seeded packed cell planes: tangents bitwise equal to phase 2's, colors
    bitwise equal to the plain version's, no dropped or truncated samples;
 8. textured resolve vs its plain version on those rows at H 1024: idx,
    alpha, ok and tex bitwise equal; the occluded-plateau case routes the
    crest's color to every row it covers;
 9. the textured main path, render_panorama(textured=True) with half-cell
    planes, a seeded 2048^2 z12 atlas around the viewer and the hybrid
    near field (exact_near_m 1200) at 4096x1024: both textured kernels
    launched, image and ranges bitwise equal to the plain versions'
    render, ranges bitwise equal to phase 5's, near colors replaced by the
    atlas; median ms/viewpoint over 20 renders with kernels (5 with plain
    versions), each textured kernel's time and each step's;
10. the API with hillshade=True on phase 6's tiles: both textured kernels
    launched, terrain gray-shaded;
11. the roll-ceiling probes (benchmarks/profile_roll_ceiling.py's kernels),
    register kernels (m a multiple of 32 that the source instantiates) and
    shared-memory kernels (any m): ptxas's registers for the register
    kernels, no spills; both flavors on both paths bitwise equal to their
    plain versions at W 4096, m 1664, 40 stages, at m 416 with tie-heavy kv
    keys, and at the edge shapes (m 32, 96, 416, 1000, 1664, 2048 x W 1, 3,
    4097 x 0, 1, 10, 13, 40, 45 stages x wide and tie-heavy keys, INT32_MIN
    and INT32_MAX in every array; m 1000 takes the general path only); the
    probe's entry point at m 1664 must launch the register kernels and at
    m 1000 the shared-memory ones; both paths timed at the default shape,
    the register kernels also at five stage counts, with the implied merge
    floors printed beside phase 5's resolve time;
12. the CLI in-process on phase 6's tiles: a 4096x1024 full circle to .pdf
    with --ranges .npy; both kernels launched, the ranges bitwise equal to
    the API's render, then the API's horizon() (march kernel) and a pick()
    that projects back into its own column;
13. both resolve entries vs the plain version at the edge shapes (H not a
    multiple of 4, K of 1, 2 and 129, all-sky and covered columns, keys at
    negative multiples of 256, thresholds equal to keys, a cliff beside a
    plateau, K at the shared-memory limit), in both alpha regimes:
    bitwise; one key more than the limit raises with the limit named;
14. both march entries vs the plain version at the edge shapes (W of 1, 31,
    33 and 37, K of 1, 2, 31, 33, 129 and 577, n of 64, 100 and 1210,
    azimuth windows inside one octant, across an octant boundary within 32
    columns and across +-180 deg, a viewer in a corner of the grid and on
    a grid line, positions that reach n-1 exactly, zfar below the second
    step tile, znear above the first crossings), with cell and half-cell
    color planes: samples and colors bitwise, NEG_BIG and the 0 color at
    the invalid samples included;
15. the LOD scene, suite config 3's per-viewpoint shape: a seeded 3601^2
    grid of bench.py's formula at cpd 3600, lat 34, viewer at the centre at
    1200 m, 2048x512, 360 deg, zfar 300 km, lod_plan's five levels: the
    pyramid on the card bitwise equal to the CPU's, each level's march
    launch (on its crop, geometry and budget) and the resolve at K 1140
    bitwise equal to their plain versions, the render bitwise equal to the
    plain versions' render; median ms over 20 camera-moved renders, each
    level's march and the resolve on the device clock, their in-frame
    times under --profile;
16. the textured LOD scene (config 9's shape): phase 15 with seeded
    colors through build_color_pyramid, from (3, n, n) cell planes and
    from a half-cell ColorPlanes2x level 0: each level's textured march
    and the render bitwise equal to the plain versions, ranges bitwise
    equal to phase 15's;
17. the API and the CLI on one synthetic SRTM1 tile (N34W118) from 34.5 N,
    117.5 W at 4096x1024 and the default zfar, which takes LOD (3 levels):
    each level's march on the API's pyramid, params and plan, the resolve
    at the API's K (about 1300) -> H 1024, and the render, bitwise equal to
    their plain versions; skyline() against degrees(arctan(horizon()))
    within 1e-4 deg, and their full-budget march (K 1600 over the whole
    grid) bitwise equal to the plain version; a
    debug_fill='wireframe' render under the swap; the CLI with --SRTM1 to
    .pdf + --horizon-out .geojson, and headless --horizon-out .csv;
18. both march entries with a batch axis against the batched plain version
    at B 1, 2, 3 and 65 (W 37, K 129; one DEM shared by the batch and one
    per viewpoint; cell and half-cell planes, shared and per viewpoint;
    viewpoints that differ in position, window, viewer_z, znear, zfar and
    curvature), bitwise, and each viewpoint against its unbatched launch;
    a batch of 330 at (4096, 1600), whose outputs pass 2^31 elements, its
    last viewpoints against unbatched launches;
19. suite config 4 (benchmarks/suite.py:145): a 60-frame path at
    1920x480 (az -60+0.5i..60+0.5i, viewer (1700+3i, 1700+2i), zfar 40 km)
    over the bench scene through render_path: one launch of each kernel
    for the batch, the batch bitwise equal to the plain versions' batch and
    to the 60 single renders; ms per frame batched and in a loop of single
    renders; the batched march and resolve on the device clock against
    bounds that count the batch's own bytes (the DEM cells as the union
    that the batch reaches, read once); peak memory, chunks;
20. suite config 8 (suite.py:288): phase 19 with seeded half-cell colours,
    ranges bitwise equal to phase 19's;
21. suite configs 3 and 9 (suite.py:122, :323): 64 LOD viewpoints (3601^2,
    cpd 3600, lat 34, 1200 m, 2048x512, zfar 300 km, viewer_cell_i = n/2 +
    13i) through render_path(sampler="lod"), untextured and with seeded
    cell colours: each level's batched march on the viewpoints' crops and
    the resolve at (64 * 2048, 1144) -> 512 bitwise against their plain
    versions, the batch against its plain versions and 64 single renders;
    times, bounds, memory as phase 19;
22. the API's render_batch on phase 6's tiles (window) and phase 17's
    SRTM1 tile (LOD), each viewpoint bitwise its own render(); fly over a
    seeded 6000^2 host grid in a 2048 window (margin 256), 32 frames in
    segments of 8, each frame bitwise its render on a window placed at the
    same origin, the uploads logged;
23. suite config 5 (suite.py:171): horizon_sweep of 1024 viewpoints on a
    32 x 32 lattice over a 1200^2 grid of bench.py's formula (W 256, zfar
    20 km, K 320 + 4): one batched march launch, the sweep bitwise equal to
    the plain versions' and to 1024 single sweeps, the batched launch
    bitwise equal to its plain version; us per viewpoint batched and as
    single sweeps, the launch on the device clock against its bound;
24. suite config 7 (suite.py:257): one 800 x 800 viewshed_grid raster at
    W 720 from the grid's centre (full circle, the contract resampler),
    then the gather resampler, a -30..140 deg window (with and without the
    full_circle promise, whose guard must then count uncovered cells) and
    a fixed frame: each raster and guard bitwise equal to the plain
    versions' (the march's and the direct masked max); ms per raster; the
    CLI's --viewshed on phase 6's tiles, its TIFF read back (tags, and the
    pixels bitwise viewshed_grid's raster, north up);
25. suite config 10 (suite.py:357): viewshed_count of 256 observers
    (default_rng(5) positions in [420, 780]) over the frame (600, 600), hw
    400, W 720, batches of 64: one march launch and one resampler launch
    (kernels/csrc/viewshed_resample.cu, the count added inside it) a
    batch, the counts bitwise equal to the plain versions' and to the sum
    of 256 single rasters, the batched launch bitwise equal to its plain
    version; us per observer batched and as single rasters; the
    resampler's two kernels on one batch bitwise resample_plain, their
    device ms (graph replay) against their bound and the plain ms;
26. shadow_light over phase 2's bench DEM (3400^2, cpd 1200, lat 34.3)
    and the SRTM1 tile of phase 17 (3601^2, cpd 3600, lat 34.5) at
    tests/test_shadows.py's six suns, a sun whose slope snaps to q = 16
    taps and one below the horizon: the light class against a brute
    float64 per-ray oracle at 4096 seeded cells (0.5 m margins, soft_m
    1e-3), at every sun the card bitwise against the same function on CPU
    tensors; the median ms of each sun against its
    bound (z read once, the light written once); sun_hours over the SRTM1
    tile for one date (8 instants of the winter solstice), bitwise
    against the CPU, timed;
27. the API with hillshade=True, shadows=True (sun 10 deg up) on phase
    6's tiles at 4096x1024: both textured kernels launched, image and
    ranges bitwise equal to the plain versions' render on the same
    planes, ranges bitwise equal to the unshadowed hillshade render's,
    terrain pixels darker and none lighter; the set-up and the planes'
    ms; then the CLI in-process with --hillshade --shadows --pois (512
    seeded POIs) --pois-out to .pdf, its GeoJSON's visible flags equal to
    visible_peaks';
28. visible_peaks of 512 seeded POIs (config 2's count) on phase 6's
    scene, the card against the CPU (flags and floats); an
    intervisibility_matrix of 256 seeded points (100 m towers) over the
    bench DEM at the auto K: symmetric, diagonal true, 16 rows bitwise
    the CPU's; its chunks and peak memory against ops.los.LOS_BYTES, the
    peak's bytes a sample against ops.los.LOS_SAMPLE_BYTES, its ms against
    two packed gathers a sample.
29. the uniform-step sampler at the bench shape (phase 2's scene,
    4096x1024, 360 deg, zfar 40 km, the API's budget K 768):
    render_panorama(sampler="step") on the bilinear and the triangulated
    surface, and at K 4096 (the resolve's other alpha regime), each
    bitwise the plain versions' render with the resolve launched; the
    resolve alone at K 768 and 4096 bitwise, timed, against its bound;
    phase 4's planar oracle through march_tanel (4e-3); march_tanel and a
    64-viewpoint horizon_batch on the card against the CPU (the same valid
    samples, within 1e-5, bitwise in the columns whose sin and cos the two
    devices round alike; the count and largest difference printed); ms per
    viewpoint (median of 20) and peak memory;
30. the grid-crossing sampler at the bench shape (K 576 + 4): the render
    bitwise the plain versions', the resolve alone at K 580, the planar
    oracle; horizon_crossing against a dense step horizon (4 steps a
    crossing step) and the window march's (tests/test_crossing.py:70-97's
    bounds: columns agree > 99%, median < 6e-4 rad, p99 < 1.5e-2);
    config 5's viewshed_sweep with its default (crossing) sampler, 16
    viewpoints bitwise their single sweeps, us per viewpoint; config 7's
    raster with the default step sampler (gather) and the crossing one
    (contract), ms per raster; the CLI's --viewshed --viewshed-sampler
    crossing on phase 6's tiles, its TIFF read back; --surface
    triangulated to .pdf (no PIL on the card's machine) with --ranges
    .npy, the ranges bitwise the API's surface="triangulated" render;
31. suite config 1 in tests/test_mesh.py:96-145's scene (1201^2,
    1024x512, -60..60 deg, znear 100 m, zfar 30 km): render_mesh_tiled
    with overflow 0; its first visible row per column against the window
    render's and the triangulated step render's: the same columns see
    terrain, error max <= 1 px, median 0; the window render's ms (config
    1's number), the step render's and the mesh's; the window march alone
    bitwise, timed, against its bound; render_mesh of the tests' 192^2
    scene on the card against the CPU (test_torch_mesh's tolerances).
32. the host front ends over phase 6's tiles: the native DEM loader built
    with g++ (no fallback) and load_mosaic of those tiles and of phase 17's
    SRTM1 tile at 40 km bitwise through the native and the numpy path
    (median ms of 5 each); the API with allow_dem_downloads from a
    loopback server of those tiles (raw, gzip, zip, a multi-member zip)
    into an empty dir: files byte for byte, the 4096x1024 render bitwise
    phase 6's, no fetch on a second construction; the viewer's
    ViewerState at 1200x400 served on 127.0.0.1 (routes, the offline map
    tile, frames decoded with zlib bitwise the API's renders after each
    move: pan, both zoom clamps, 4096x1024 and back, the w overlay, the e
    fills through the textured kernels, a re-centre; pick on terrain and
    sky), the median ms of a move over 20 pans split into render, PNG
    encode and the rest; `python -m horizonator_tpu_torch.viewer` in a
    subprocess, the CLI's interactive mode (viewer.serve stood in), and
    the CLI's --image .png decoded bitwise the API's image;
33. scale-out: first both banded march entries (textured at s = 1 and 2)
    bitwise their plain version at the band edge shapes
    (band_edge_cases(): bands beyond zfar and of padding alone (j_hi < 0),
    bands of one valid row, one valid sample, band edges inside a tile
    and a warp (R 3 and 8 over a grid they do not divide), the viewer
    inside, on the first and last row, north and south of the band, all
    row- and all column-dominant columns, a batch of 3 with a band each),
    the bands' MAX bitwise the square march where they cover the grid;
    then the banded march entries (untextured and half-cell
    textured) on the 4 row bands (850 rows + a halo row) of phase 2's
    grid bitwise their plain version, their MAX bitwise the square march;
    every rank's local function of the region renderer (4 bands; 2 bands
    x 2 wedges), combined as the collectives combine them, against the
    single render (bitwise; the wedges within the JAX tests' tolerance at
    all but 0.2% of pixels), untextured and textured hybrid, launching
    the band entry once a band; through a one-rank NCCL group, the API's
    region_mesh="auto" (untextured, and textured hybrid from a cache of
    seeded PNG tiles, 8-bit palette and 8-bit RGB rows filtered 0-4,
    decoded by the port, each API's atlas equal to the tiles' pixels)
    bitwise the plain API's renders, render_batch(mesh="auto")
    of 8 viewpoints and config 10's viewshed_count(mesh="auto") against
    one device; the band entries' device ms a band against their bound
    and a write-only pass over their outputs, with each band's live tiles
    (32 columns x 64 steps holding a valid sample of the plain version).
34. profiling and the host paths without PIL or requests (both blocked
    through sys.modules for the phase): profiling.device_time of the bench
    render (ms a viewpoint, within 2x of phase 5's CUDA-events median), a
    PhaseTimer over the render's steps (its report; under --profile each
    phase name in the torch.profiler table), device_time_chain over 16
    camera-moved renders; _png.decode_png of a palette, an RGB (filters
    0-4) and a Paeth RGB tile through the native unfilter (g++, no
    fallback; the plain one timed beside it) and of the API scene's
    whole atlas, ms a tile; the CLI's --pois to .svg on phase 6's tiles,
    its embedded PNG decoded bitwise the API's image; a loopback server
    of seeded tiles (some with Expires) and an Overpass-shaped answer: a
    textured API with downloads into an empty cache (every file byte for
    byte, .expires where sent, the atlas the tiles' pixels, the render
    bitwise one from a local cache), the viewer's /tiles/ route on a
    cache miss, and fetch_peaks (a form-encoded data= body).
Phases 26-32 and 34 add no kernel (their ops are the JAX package's XLA
ops, in plain PyTorch, or host code); phase 27 runs the two textured
kernels, phases 29-30 the resolve, phase 31 the march and the resolve,
phases 32 and 34 all four render entries.
Each phase group prints its seconds ("[t]" lines).
A kernel's "device ms" (the ``ms`` of its record) is the replay time of a
CUDA graph of back-to-back launches over their count, so no Python runs in
the timed region; the "host-loop ms" printed before it is the same wrapper
called from a Python loop, which for kernels this short is the host's
launch interval. The fill_ yardsticks are the device time of writing a
kernel's outputs and nothing else.
The probes' records: roll_minmax and roll_kv are the register kernels at
the probe's default shape with the launches of its entry point there;
roll_minmax_smem and roll_kv_smem are timed at the same shape, their
launches those of the entry point at m 1000.
Each kernel's record carries its bound: the larger of the bytes it must
move (each input read once, each output written once) over 3.35 TB/s and
its operations over the card's rate for their type (float32 67 TFLOP/s;
int32 64 per SM per clock at clocks.max.sm). The four render entries add
their LOD records: ``lod_launches`` per LOD render (phase 15 or 16),
``lod_ms`` (each level's march, or the resolve at K 1140, on the device
clock) and ``lod_in_frame_ms`` (the same from the profiler inside real
renders, under --profile; else null). The same four carry ``batch``: a
list of the batch cells' records (phases 19-21; window_march also 23-25),
each with its cell, ``batch`` (viewpoints), ``launches`` (per batch),
``ms`` and ``bound_ms`` of the batched launch (configs 3 and 9: the sum
over the levels, with ``levels`` itemized), ``ms_per_frame`` (per frame,
viewpoint, raster or observer), ``ms_per_frame_single_loop``,
``device_busy`` (under --profile; else null), ``peak_mb`` and ``chunks``.
The banded entries (window_march_band, window_march_band_textured) are
timed per band; their ``ms`` and ``bound_ms`` are the means over the 4
bands, ``bands`` lists each (with ``live_tiles`` of ``tiles``,
``fill_ms``, a write-only pass over the band's outputs, ``in_frame_ms``,
its launch's device ms inside region renders under torch.profiler, and
``host_loop_ms``; the record carries their means), and ``launches`` are
those of one region render of 4 bands. The
resolve and window_march entries carry ``oracle``: the records of
their launches on phases 29-31's paths (cell, K, launches, ms, plain_ms,
bound_ms, bound_by; config 1's also its render's ms_per_frame).
Every number printed stands beside the card's name and power limit
(phase 1's line and the line before the last). The last lines of standard
output are the card, the kernels' JSON record and {"ok": true, ...}.
"""

import inspect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W, H = 4096, 1024
LAT = 34.3
LON = -117.6          # where the bench grid's centre is placed for the atlas
ZFAR = 40000.0
CPD = 1200
N = 3400
RENDERS = 20
PLAIN_TEX_RENDERS = 5
EXACT_NEAR_M = 1200.0
PROBE_M, PROBE_STAGES = 1664, 40
HOST_LOOP = 100               # wrapper calls of a host-loop timing
GRAPH_LAUNCHES = 64           # render-kernel launches in a timed CUDA graph
PROBE_GRAPH_LAUNCHES = 16
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# float32 operations of the near band (FMA = 2), counted from
# near_band.cu: a column's trigonometry (two library calls, ~20 each) and
# near_hi; a sample's distance, position, bounds, taps, hats and tangent
NEAR_FLOPS_COLUMN, NEAR_FLOPS_SAMPLE = 50, 60
# float32 operations per march sample (FMA = 2), counted from
# window_march.cu: position, axis, distance, bounds, hats, taps, tangent;
# the textured entry adds the color hats and three channels
MARCH_FLOPS, MARCH_TEX_FLOPS = 30, 60
# int32 operations that the probes' function needs per lane and stage. The
# lane mask and its test are constants once the stage and the lane's place
# are known when the code is compiled, and the two lanes of a pair (i, i+d)
# need one min and one max: 1. kv: one key compare per pair and four
# selects (two keys, two values): 2.5. The partner index is bookkeeping.
PROBE_OPS, PROBE_KV_OPS = 1, 2.5
# phase 11's edge shapes: m with d >= m (d % m != d), one that is not a
# multiple of 32 (the shared-memory kernels only), ragged W, stage counts
# from none to more than four rounds of the ten shifts
PROBE_EDGE_M = (32, 96, 416, 1000, 1664, 2048)
PROBE_EDGE_W = (1, 3, 4097)
PROBE_EDGE_STAGES = (0, 1, 10, 13, 40, 45)
PROBE_GENERAL_M = 1000        # the probe's entry point on the general path
# phases 15-16: suite config 3's (and 9's, textured) per-viewpoint shape,
# an SRTM1 tile (3601^2, cpd 3600) to 300 km at 2048x512
LOD_N, LOD_CPD, LOD_LAT, LOD_ZFAR = 3601, 3600, 34.0, 300000.0
LOD_W, LOD_H = 2048, 512
LOD_VZ = 1200.0
LOD_LEVELS = 5                # lod_plan's levels at that shape
SRTM1_LEVELS = 3              # phase 17's: SRTM1 at 40 km over 4096 columns
# phases 19-21: the suite's batch cells (benchmarks/suite.py): configs 4 and
# 8, a 60-frame path at 1920x480; configs 3 and 9, 64 LOD viewpoints
PATH_FRAMES, PATH_W, PATH_H, PATH_LAT = 60, 1920, 480, 34.3
LOD_BATCH = 64
BATCH_GRAPH_LAUNCHES = 8      # batched launches in a timed CUDA graph
SINGLE_LOOPS = 3              # timed loops of single renders
# phase 18's batch whose outputs pass 2^31 elements: (B, W, K, n)
BIG_BATCH = (330, 4096, 1600, 1210)
# phase 22's fly-through: host grid edge, window, margin, frames a segment,
# frames
FLY_N, FLY_WINDOW, FLY_MARGIN, FLY_CHUNK, FLY_FRAMES = 6000, 2048, 256, 8, 32
# phases 23-25: the suite's viewshed cells over a 1200^2 grid to 20 km:
# config 5, a 32 x 32 lattice of viewpoints at W 256; configs 7 and 10, an
# 800 x 800 raster at W 720, and 256 observers counted in batches of 64
VS_N, VS_ZFAR = 1200, 20000.0
SWEEP_W, SWEEP_GRID = 256, 32
VS_HW, VS_W = 400, 720
COUNT_OBS, COUNT_BATCH = 256, 64
COUNT_CENTER, COUNT_SPREAD = 600.0, (420.0, 780.0)
# phase 26: tests/test_shadows.py:126-133's suns (az, alt), and a sun whose
# slope snaps to q = 16 taps, searched from this azimuth at each grid's
# latitude
SHADOW_SUNS = ((90.0, 25.0), (0.0, 35.0), (45.0, 30.0), (112.0, 20.0),
               (247.0, 40.0), (183.0, 10.0))
SHADOW_Q16_FROM, SHADOW_ORACLE_CELLS = 100.0, 4096
# sun_hours' winter day and 8 instants keep its CPU run to 3 suns
SUN_HOURS_DATE, SUN_HOURS_SAMPLES = "2026-12-21", 8
# phases 29-31: the oracle samplers. The step renders take the API's
# uniform budget (1.5 steps a cell, a multiple of 256: K 768 at the bench
# shape); one at K 4096 takes the resolve's other alpha regime. Phase 29's
# horizon_batch: 64 viewpoints at W 256; phase 30 sweeps 16 of config 5's
# viewpoints one by one. Phase 4's plane: z0, slopes a (i) and b (j), the
# viewer's height above it
STEP_OVERSAMPLE, STEP_K_WIDE = 1.5, 4096
HB_VIEWS, HB_W, ORACLE_SINGLES = 64, 256, 16
PLANE = (1200.0, 0.6, -0.35, 25.0)
# phase 31: suite config 1 (benchmarks/suite.py:72) in the scene of
# tests/test_mesh.py:96-145: a 1201^2 tile, 1024x512, -60..60 deg, znear
# 100 m, zfar 30 km
C1_N, C1_W, C1_H, C1_ZFAR, C1_LAT = 1201, 1024, 512, 30000.0, 34.3
# phases 5 and 28: suite config 2's POI count (benchmarks/suite.py:110-114);
# phase 28's intervisibility matrix
POIS_N, LOS_POINTS, LOS_CHECK_ROWS = 512, 256, 16


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
    """Mean time of fn() over a Python loop of n back-to-back calls between
    two CUDA events: the "host-loop ms". For a kernel of a few tens of
    microseconds this is the wrapper's launch interval on the host, not the
    kernel's time; ``graph_ms`` gives that."""
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


def graph_ms(fn, n, replays=5):
    """Device time of one launch of the wrapper fn(): n launches captured
    in one CUDA graph, the median of ``replays`` replays between two CUDA
    events, over n. No Python runs inside the timed region. Every launch's
    outputs stay alive through the capture, so each launch writes memory of
    its own; the inputs are the same tensors for every launch, so they sit
    in the L2 cache as far as they fit, as the frame leaves them."""
    fn()
    torch.cuda.synchronize()
    graph, keep = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(n):
            keep.append(fn())
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    del graph, keep
    return statistics.median(times) / n


def fill_ms(nbytes):
    """A write-only yardstick: the device time of one torch fill_ of nbytes
    of fresh memory, what the card takes to write a kernel's outputs and do
    nothing else."""
    return graph_ms(lambda: torch.empty(nbytes, dtype=torch.uint8,
                                        device="cuda").fill_(1),
                    GRAPH_LAUNCHES)


def int32_ops_per_s():
    """H100 int32 rate: 64 lanes per SM per clock at the card's maximum SM
    clock."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, check=True, timeout=60)
    mhz = float(r.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * mhz * 1e6, mhz, sms


def bound(nbytes, ops, ops_per_s):
    """(bound ms, what bounds it): bytes over the memory rate against
    operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 nbytes, ops, ops_per_s):
    b_ms, b_by = bound(nbytes, ops, ops_per_s)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def max_chan(a, b):
    """Largest per-channel difference of two packed 0x00RRGGBB tensors."""
    return max((((a >> sh) & 0xff) - ((b >> sh) & 0xff)).abs().max().item()
               if a.numel() else 0 for sh in (0, 8, 16))


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


def profile_renders(fn, n, card, out_path, title, kernel_names,
                    per_launch=None):
    """torch.profiler over n calls of fn(i), its table written to out_path;
    returns the device's busy ms per call and, for each of ``kernel_names``
    (substrings of the CUDA kernels' names), the mean device ms of that
    kernel's launches inside those calls. ``per_launch``: a dict whose
    values, lists, receive each launch's device ms of the kernel named by
    their key, in launch order."""
    from torch.profiler import ProfilerActivity, profile as tprof
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for name, durations in (per_launch or {}).items():
        launches = sorted((e.time_range.start, e.self_device_time_total)
                          for e in prof.events()
                          if e.device_type == cuda and name in e.name)
        durations.extend(us / 1e3 for _, us in launches)
    averages = prof.key_averages()
    table = averages.table(sort_by="self_cuda_time_total", row_limit=100)
    in_frame = {}
    for name in kernel_names:
        rows = [e for e in averages if name in e.key
                and e.self_device_time_total > 0]
        if not rows:
            fail(f"profile of {title}: no device time for {name}")
        in_frame[name] = (sum(e.self_device_time_total for e in rows) / 1e3
                          / sum(e.count for e in rows))
    busy = sum(e.self_device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(f"{card}\n{title}\n{table}\n")
    return busy, in_frame


def textured_phases(c, tiles, profile_dir=None):
    """Phases 7-10 on phase 2's scene (``c``) and phase 6's tiles; returns
    the textured kernels' JSON entries."""
    from horizonator_tpu_torch import horizonator
    from horizonator_tpu_torch.kernels.resolve import (resolve,
                                                       resolve_plain,
                                                       resolve_textured)
    from horizonator_tpu_torch.kernels.window_march import (march,
                                                            march_plain,
                                                            march_textured)
    from horizonator_tpu_torch.render import render_panorama
    from horizonator_tpu_torch.render.crossing import crossing_geometry
    from horizonator_tpu_torch.render.raymarch import (horizon_rows,
                                                       resolve_to_image)
    from horizonator_tpu_torch.render.resolve_window import (alpha_quantum,
                                                             resolve_window)
    from horizonator_tpu_torch.render.texture import (AtlasParams,
                                                      pack_cell_colors,
                                                      prepare_color_planes,
                                                      tile_xy_from_latlon)
    from horizonator_tpu_torch.render.window import march_from_geometry
    dev, dem, p, geo = c["dev"], c["dem"], c["p"], c["geo"]
    mkw, rkw, tan_k, y_k = c["mkw"], c["rkw"], c["tan_k"], c["y_k"]
    n = dem.shape[0]

    def count_reset():
        march.launches = resolve.launches = 0
        march_textured.launches = resolve_textured.launches = 0

    # -- 7. textured march: kernel vs plain ----------------------------------
    rng3 = np.random.default_rng(3)
    cp2 = prepare_color_planes(torch.from_numpy(rng3.integers(
        0, 256, (3, 2 * n, 2 * n), dtype=np.uint8)).to(dev).float())
    cp1 = pack_cell_colors(torch.from_numpy(rng3.integers(
        0, 256, (3, n, n), dtype=np.uint8)).to(dev).float())
    valid = tan_k > -1e30
    for name, planes in (("half-cell", cp2), ("cell", cp1)):
        tt_k, d_k, tx = march_from_geometry(dem, p, geo, color_planes=planes,
                                            **mkw)
        tt_p, d_p, tx_p = march_from_geometry(dem, p, geo, plain=True,
                                              color_planes=planes, **mkw)
        torch.cuda.synchronize()
        guards = [int(d.dropped) + int(d.truncated) for d in (d_k, d_p)]
        if guards != [0, 0]:
            fail(f"textured march ({name}) guards {guards}")
        if not (torch.equal(tt_k, tan_k) and torch.equal(tt_p, tan_k)):
            fail(f"textured march ({name}) tangents != untextured")
        if not torch.equal(tx, tx_p):
            fail(f"textured march ({name}) tex != plain: "
                 f"{int((tx != tx_p).sum())} samples differ")
        if (tx[~valid] != 0).any() or float(
                (tx[valid] != 0).float().mean()) < 0.99:
            fail(f"textured march ({name}): colors do not ride the samples")
        if name == "half-cell":
            tx_k, march_err = tx, float(max_chan(tx, tx_p))
        log(f"[7] textured march ({name} planes): tanel == phase 2 bitwise, "
            f"tex == plain bitwise; dropped=truncated=0")
    del tx, tx_p, tt_k, tt_p

    # -- 8. textured resolve: kernel vs plain --------------------------------
    out_k = resolve_window(y_k, H, tex=tx_k)
    out_p = resolve_window(y_k, H, tex=tx_k, plain=True)
    torch.cuda.synchronize()
    for name, a, b, u in zip(("idx", "alpha", "ok", "tex"), out_k, out_p,
                             (*c["res_k"], None)):
        if not torch.equal(a, b):
            fail(f"textured resolve {name} != plain: "
                 f"{int((a != b).sum())} differ")
        if u is not None and not torch.equal(a, u):
            fail(f"textured resolve {name} != untextured resolve")
    resolve_err = max(max_abs(out_k[0], out_p[0]), max_abs(out_k[1], out_p[1]),
                      float(max_chan(out_k[3], out_p[3])))
    k_tot = y_k.shape[1]
    if (out_k[3][out_k[0] >= k_tot] != 0).any():
        fail("textured resolve: sky rows carry a color")
    for h in (256, 4096):       # the JAX package's fused and fallback regime
        yp = torch.full((4, 256), 240.0, device=dev)
        yp[:, 10] = 50.0                            # the visible crest
        yp[:, 11:48] = 120.0                        # occluded behind it
        tp = (torch.arange(256, dtype=torch.int32, device=dev) + 1).expand(
            4, 256).contiguous()
        idx_p, _, _, tex_p = resolve_window(yp, h, tex=tp)
        cov = slice(50, 240)
        if not ((idx_p[:, cov] == 10).all() and (tex_p[:, cov] == 11).all()):
            fail(f"textured resolve plateau case at H {h}")
    log(f"[8] textured resolve {tuple(y_k.shape)} -> H={H}: kernel == plain "
        f"bitwise (idx, alpha, ok, tex), idx/alpha/ok == phase 3; plateau "
        f"case routes the crest's color at H 256 and 4096")

    # -- 9. the textured main path -------------------------------------------
    # the viewer placed at (LAT, LON); an 8x8-tile z12 atlas around its tile
    o_lon = LON - float(p.viewer_cell_i) / CPD
    o_lat = LAT - float(p.viewer_cell_j) / CPD
    tx0, ty0 = tile_xy_from_latlon(LAT, LON, 12)
    ap = AtlasParams(o_lon, o_lat, tx0 - 4, ty0 - 4, 8, 8)
    atlas = torch.from_numpy(np.random.default_rng(4).integers(
        0, 1 << 24, (2048, 2048), dtype=np.int32)).to(dev)
    tkw = dict(textured=True, color_planes=cp2, atlas=atlas, atlas_params=ap,
               exact_near_m=EXACT_NEAR_M, **rkw)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    count_reset()
    img, rng, guard = render_panorama(dem, p, with_dropped=True, **tkw)
    torch.cuda.synchronize()
    launches = {"window_march_textured": march_textured.launches,
                "resolve_textured": resolve_textured.launches}
    peak_mb = (torch.cuda.max_memory_allocated() - base_mem) / 1e6
    if min(launches.values()) < 1:
        fail(f"textured main path skipped a kernel: {launches}")
    if guard.tolist() != [0, 0] or img.shape != (H, W, 3):
        fail(f"bad textured render {img.shape} {guard.tolist()}")
    img_p, rng_p = render_panorama(dem, p, plain=True, **tkw)
    if not (torch.equal(img, img_p) and torch.equal(rng, rng_p)):
        fail("textured kernel render != plain render")
    if not torch.equal(rng, c["rng"]):
        fail("textured ranges != untextured ranges")
    terr = rng > 0
    if int(img[..., 1][terr].to(torch.int64).sum()) == 0:
        fail("textured terrain carries no green: the colors did not arrive")
    if not (img[~terr] == torch.tensor([255, 0, 0], dtype=torch.uint8,
                                       device=dev)).all():
        fail("textured sky is not (255, 0, 0)")
    _, _, tx_h = march_from_geometry(dem, p, geo, color_planes=cp2,
                                     atlas=atlas, atlas_params=ap,
                                     exact_near_m=EXACT_NEAR_M, **mkw)
    replaced = int((tx_h != tx_k).sum())
    if replaced < 1:
        fail("the hybrid near field replaced no color")
    log(f"[9] textured render {W}x{H}: visible {float(terr.float().mean()):.4f},"
        f" launches {launches}, image and ranges == plain-version render "
        f"bitwise, ranges == phase 5 bitwise; hybrid near field replaced "
        f"{replaced} sample colors; peak extra device memory {peak_mb:.1f} MB")
    mem = {"dem": dem.nbytes, "half-cell plane": cp2.full_packed.nbytes,
           "cell plane": cp1.nbytes, "atlas": atlas.nbytes}
    log("[9] device memory held by the textured scene: " + ", ".join(
        f"{k} {v / 1e6:.1f} MB" for k, v in mem.items()))

    params = c["params"]
    ms_kernel = cuda_ms(lambda i: render_panorama(dem, params[i], **tkw),
                        RENDERS)
    ms_plain = cuda_ms(lambda i: render_panorama(dem, params[i], plain=True,
                                                 **tkw), PLAIN_TEX_RENDERS,
                       warmup=1)
    run_kernel = cuda_ms_run(
        lambda i: render_panorama(dem, params[i], **tkw), RENDERS)
    log(f"[9] textured ms/viewpoint (median, CUDA events): kernels "
        f"{ms_kernel:.3f} over {RENDERS}, plain versions {ms_plain:.3f} over "
        f"{PLAIN_TEX_RENDERS}; back-to-back run of {RENDERS} with kernels: "
        f"{run_kernel:.3f} ms each")

    pcol, fscal, k_lim = c["pcol"], c["fscal"], c["k_lim"]
    plane = cp2.full_packed
    amax, int_first = alpha_quantum(k_tot, H)
    hl_march = cuda_ms_run(lambda i: march_textured(dem, pcol, fscal, k_lim,
                                                    plane, 2), HOST_LOOP)
    hl_res = cuda_ms_run(lambda i: resolve_textured(y_k, tx_k, H, amax,
                                                    int_first), HOST_LOOP)
    log(f"[9] host-loop ms ({HOST_LOOP} wrapper calls from Python): "
        f"textured window march {hl_march:.4f}, textured resolve "
        f"{hl_res:.4f}")
    t_march = graph_ms(lambda: march_textured(dem, pcol, fscal, k_lim, plane,
                                              2), GRAPH_LAUNCHES)
    t_res = graph_ms(lambda: resolve_textured(y_k, tx_k, H, amax, int_first),
                     GRAPH_LAUNCHES)
    t_march_p = cuda_ms_run(lambda i: march_plain(dem, pcol, fscal, k_lim,
                                                  plane, 2), 20)
    t_res_p = cuda_ms_run(lambda i: resolve_plain(y_k, H, amax, int_first,
                                                  tex=tx_k), 50)
    log(f"[9] device ms (graph replay, {GRAPH_LAUNCHES} launches): textured "
        f"window march {t_march:.4f} (plain {t_march_p:.4f}), textured "
        f"resolve {t_res:.4f} (plain {t_res_p:.4f}); yardsticks: fill_ of "
        f"the textured march's {8 * W * k_lim / 1e6:.2f} MB of outputs "
        f"{fill_ms(8 * W * k_lim):.4f}, of the textured resolve's "
        f"{13 * W * H / 1e6:.2f} MB {fill_ms(13 * W * H):.4f}")
    dists = c["dists"]
    steps = {
        "geometry": lambda i: crossing_geometry(p, width=W, cells_per_deg=CPD),
        "textured march (kernel + near band + hybrid + guards)":
            lambda i: march_from_geometry(
                dem, p, geo, color_planes=cp2, atlas=atlas, atlas_params=ap,
                exact_near_m=EXACT_NEAR_M, **mkw),
        "row map (atan)":
            lambda i: horizon_rows(tan_k, p, width=W, height=H),
        "textured resolve + tail (resolve_to_image)":
            lambda i: resolve_to_image(tan_k, dists.d_of, geo.az, p,
                                       width=W, height=H, textured=True,
                                       tex_samples=tx_h),
    }
    for name, fn in steps.items():
        log(f"[9] step {name}: {cuda_ms(fn, 20):.4f} ms")
    if profile_dir:
        out = os.path.join(profile_dir, "profile_render_textured.txt")
        busy, in_frame = profile_renders(
            lambda i: render_panorama(dem, params[i], **tkw), 5, c["card"],
            out, f"5 textured renders {W}x{H}",
            ("window_march_kernel<true", "resolve_kernel<true"))
        log(f"[9] profile: device busy {busy:.3f} ms per textured render of "
            f"{ms_kernel:.3f} ms ({100 * busy / ms_kernel:.1f}%); table in "
            f"{out}")
        log("[9] profile: mean device ms inside the textured frame: "
            + ", ".join(f"{k} {v:.4f}" for k, v in in_frame.items())
            + f" (graph replay: march {t_march:.4f}, resolve {t_res:.4f})")
    del cp1, img_p, rng_p

    # -- 10. the API with hillshade -------------------------------------------
    h = horizonator(34.4, -117.6, W, H, dir_dems=tiles, hillshade=True,
                    device=dev)
    count_reset()
    img10, rng10 = h.render(-180, 180)
    api_launches = {"window_march_textured": march_textured.launches,
                    "resolve_textured": resolve_textured.launches}
    if min(api_launches.values()) < 1:
        fail(f"hillshade API render skipped a kernel: {api_launches}")
    if img10.shape != (H, W, 3) or rng10.shape != (H, W):
        fail(f"bad hillshade output {img10.shape} {rng10.shape}")
    vis10 = float((rng10 > 0).mean())
    if not 0.05 < vis10 < 0.95:
        fail(f"degenerate hillshade visible fraction {vis10}")
    b, g, r = (img10[rng10 > 0][:, ch].astype(np.int64) for ch in range(3))
    if not ((b == g).all() and (r >= g).all() and g.mean() > 20.0
            and g.std() > 0.5):
        fail(f"hillshade terrain is not gray-shaded: B==G "
             f"{bool((b == g).all())}, G mean {g.mean():.2f} std "
             f"{g.std():.2f}")
    ms_api = cuda_ms(lambda i: h.render(-180 + i, 180 + i), 5, warmup=1)
    log(f"[10] hillshade API render {W}x{H} of {h.mosaic.grid.shape} grid: "
        f"visible {vis10:.4f}, launches {api_launches}, gray G mean "
        f"{g.mean():.2f} std {g.std():.2f}; {ms_api:.3f} ms per render "
        f"(median of 5, outputs copied to the host)")

    # bounds: the untextured work plus the half-cell texels in the zfar
    # disk (4 per cell) and the (W, K) colors out; the resolve adds the
    # (W, K) colors in and the (W, H) colors out
    m_bytes, m_samples = c["march_bytes"], W * k_lim
    r_bytes, r_ops = c["resolve_bytes"], c["resolve_ops"]
    return [
        kernel_entry("window_march_textured",
                     "horizonator_tpu_torch/kernels/csrc/window_march.cu",
                     "horizonator_tpu/render/window.py:452",
                     launches["window_march_textured"], march_err, t_march,
                     t_march_p, m_bytes + 16 * c["disk_cells"]
                     + 4 * m_samples, MARCH_TEX_FLOPS * m_samples,
                     FP32_OPS_PER_S),
        kernel_entry("resolve_textured",
                     "horizonator_tpu_torch/kernels/csrc/resolve.cu",
                     "horizonator_tpu/render/resolve_window.py:132",
                     launches["resolve_textured"], resolve_err, t_res,
                     t_res_p, r_bytes + 4 * y_k.numel() + 4 * W * H,
                     r_ops + W * H, c["int32_rate"]),
    ]


def ptxas_table(nvcc_log):
    """{kernel's mangled name: [registers, spill store bytes, spill load
    bytes]} from the build's ``-Xptxas -v`` log."""
    out, cur = {}, None
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), [0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur[1:] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur[0] = int(m.group(1))
    return out


def probe_edge_inputs(gen, w, m, ties):
    """Seeded (x, keys, values) (w, m) int32 on gen's device: full-range x
    and values, keys full-range or in 0..15, and 3% of each array at
    INT32_MIN and 3% at INT32_MAX."""
    dev = gen.device
    out = []
    for lo, hi in ((-2 ** 31, 2 ** 31), (0, 16) if ties else
                   (-2 ** 31, 2 ** 31), (-2 ** 31, 2 ** 31)):
        a = torch.randint(lo, hi, (w, m), dtype=torch.int64, device=dev,
                          generator=gen).to(torch.int32)
        u = torch.rand((w, m), device=dev, generator=gen)
        a[u < 0.03] = -2 ** 31
        a[(u >= 0.03) & (u < 0.06)] = 2 ** 31 - 1
        out.append(a)
    return out


def probe_phase(int32_rate, resolve_ms, nvcc_log):
    """Phase 11: the roll-ceiling probes, both paths; returns their JSON
    entries (what each holds: the module docstring)."""
    from horizonator_tpu_torch.benchmarks import profile_roll_ceiling as prc
    from horizonator_tpu_torch.kernels import roll_ceiling as rc
    w, m, st = prc.W, PROBE_M, PROBE_STAGES
    if not rc.register_path(m):
        fail(f"m {m} does not take the register kernels")
    if nvcc_log:
        regs = {}
        for name, (nreg, sst, sld) in ptxas_table(nvcc_log).items():
            g = re.search(r"roll_regsILi(\d+)ELb([01])E", name)
            if g:
                regs[("kv" if g.group(2) == "1" else "minmax",
                      int(g.group(1)))] = (nreg, sst, sld)
        spills = {k: v for k, v in regs.items() if v[1] or v[2]}
        if not regs or spills:
            fail(f"register kernels: none in the ptxas log, or spills "
                 f"{spills}")
        log("[11] ptxas, register kernels (flavor R: registers): "
            + ", ".join(f"{f} {r}: {v[0]}"
                        for (f, r), v in sorted(regs.items()))
            + "; no spills")
    kernels = {"roll_minmax": (rc.roll_minmax, rc.roll_kv),
               "roll_minmax_smem": (rc.roll_minmax_smem, rc.roll_kv_smem)}
    err = {"roll_minmax": 0.0, "roll_kv": 0.0, "roll_minmax_smem": 0.0,
           "roll_kv_smem": 0.0}

    def check(xr, k, v, s, label):
        """Both flavors on every path that serves m, against the plain
        versions, bitwise; returns the paths checked."""
        ref = [rc.roll_minmax_plain(xr, s), *rc.roll_kv_plain(k, v, s)]
        paths = [p for p in kernels
                 if p.endswith("smem") or rc.register_path(xr.shape[1])]
        for path in paths:
            mm_fn, kv_fn = kernels[path]
            got = [mm_fn(xr, s), *kv_fn(k, v, s)]
            torch.cuda.synchronize()
            for what, a, b in zip(("minmax", "kv keys", "kv values"), got,
                                  ref):
                if not torch.equal(a, b):
                    fail(f"{path} {what} != plain at {label}: "
                         f"{int((a != b).sum())} lanes differ")
            kv_name = path.replace("minmax", "kv")
            err[path] = max(err[path], max_abs(got[0], ref[0]))
            err[kv_name] = max(err[kv_name], max_abs(got[1], ref[1]),
                               max_abs(got[2], ref[2]))
        return paths, float((ref[2] != v).float().mean()) if v.numel() else 0

    x = prc.probe_input(w, m)
    dev = x.device
    rng = np.random.default_rng(11)
    x416 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (w, 416),
                                         dtype=np.int64).astype(np.int32))
    k416 = torch.from_numpy(rng.integers(0, 16, (w, 416),
                                         dtype=np.int64).astype(np.int32))
    _, moved = check(x, x, x + 1, st, f"m {m}")
    x416, k416 = x416.to(dev), k416.to(dev)
    _, moved416 = check(x416, k416, x416 + 1, st, "m 416")
    log(f"[11] roll_minmax and roll_kv (W {w}, {st} stages) == plain "
        f"bitwise on both paths at m {m} (probe input) and m 416 (seeded, "
        f"kv keys in 0..15); kv values moved at {moved:.3f} / "
        f"{moved416:.3f} of lanes")
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    served = {"roll_minmax": 0, "roll_minmax_smem": 0}
    for mm in PROBE_EDGE_M:
        for we in PROBE_EDGE_W:
            for ties in (False, True):
                xe, ke, ve = probe_edge_inputs(gen, we, mm, ties)
                for s in PROBE_EDGE_STAGES:
                    paths, _ = check(xe, ke, ve, s,
                                     f"W {we}, m {mm}, {s} stages, "
                                     f"{'tie' if ties else 'wide'} keys")
                    for p in paths:
                        served[p] += 1
    log(f"[11] edge shapes: m {PROBE_EDGE_M} x W {PROBE_EDGE_W} x stages "
        f"{PROBE_EDGE_STAGES} x keys wide and in 0..15, INT32_MIN and "
        f"INT32_MAX in every array: == plain bitwise on the register path "
        f"in {served['roll_minmax']} cases and the shared-memory path in "
        f"{served['roll_minmax_smem']}")

    t_mm_p = cuda_ms_run(lambda i: rc.roll_minmax_plain(x, st), 5, warmup=1)
    t_kv_p = cuda_ms_run(lambda i: rc.roll_kv_plain(x, x + 1, st), 5,
                         warmup=1)
    counters = (rc.roll_minmax, rc.roll_kv, rc.roll_minmax_smem,
                rc.roll_kv_smem)

    def entry_point(mm):
        """The probe's entry point at m mm, counts from 0 around it."""
        for fn in counters:
            fn.launches = 0
        eps_ms = [prc.run(f, w, mm, st) for f in ("minmax", "kv")]
        return eps_ms, {fn.__name__: fn.launches for fn in counters}

    # the probe's entry point is this path: the default shape takes the
    # register kernels, m PROBE_GENERAL_M the shared-memory ones
    (run_mm, run_kv), launches = entry_point(m)
    if min(launches["roll_minmax"], launches["roll_kv"]) < 1 or max(
            launches["roll_minmax_smem"], launches["roll_kv_smem"]):
        fail(f"the probe at m {m} did not take the register kernels: "
             f"{launches}")
    _, gen_launches = entry_point(PROBE_GENERAL_M)
    if min(gen_launches["roll_minmax_smem"],
           gen_launches["roll_kv_smem"]) < 1 or max(
            gen_launches["roll_minmax"], gen_launches["roll_kv"]):
        fail(f"the probe at m {PROBE_GENERAL_M} did not take the "
             f"shared-memory kernels: {gen_launches}")
    log(f"[11] probe W {w} m {m} S {st}, host-loop ms (the entry point's "
        f"own timing: 16 wrapper calls from Python between two CUDA "
        f"events): minmax {run_mm[1]:.4f} ({run_mm[0] / 1e9:.0f} G "
        f"elem-stages/s), kv {run_kv[1]:.4f} ({run_kv[0] / 1e9:.0f} G "
        f"elem-stages/s, 2 arrays); launches {launches}; at m "
        f"{PROBE_GENERAL_M}: {gen_launches}")
    x1 = x + 1
    calls = {"roll_minmax": lambda: rc.roll_minmax(x, st),
             "roll_kv": lambda: rc.roll_kv(x, x1, st),
             "roll_minmax_smem": lambda: rc.roll_minmax_smem(x, st),
             "roll_kv_smem": lambda: rc.roll_kv_smem(x, x1, st)}
    host = {n: cuda_ms_run(lambda i: fn(), HOST_LOOP) for n, fn in
            calls.items()}
    dev_ms = {n: graph_ms(fn, PROBE_GRAPH_LAUNCHES) for n, fn in
              calls.items()}
    lanes = w * m
    work = {n: ((16, PROBE_KV_OPS) if "kv" in n else (8, PROBE_OPS))
            for n in calls}
    work = {n: (b * lanes, ops * lanes * st) for n, (b, ops) in work.items()}
    bounds = {n: bound(*work[n], int32_rate) for n in calls}
    log(f"[11] W {w} m {m} S {st}, device ms (graph replay, "
        f"{PROBE_GRAPH_LAUNCHES} launches) / host-loop ms ({HOST_LOOP} "
        f"calls) / share of the bound: " + ", ".join(
            f"{n} {dev_ms[n]:.4f} / {host[n]:.4f} / "
            f"{100 * bounds[n][0] / dev_ms[n]:.1f}% of {bounds[n][0]:.5f} "
            f"({bounds[n][1]})" for n in calls)
        + f"; plain minmax {t_mm_p:.4f}, kv {t_kv_p:.4f}; register path "
        f"{dev_ms['roll_minmax_smem'] / dev_ms['roll_minmax']:.2f}x and "
        f"{dev_ms['roll_kv_smem'] / dev_ms['roll_kv']:.2f}x the "
        f"shared-memory path")
    # the register kernels' time against their stage count: at 0 stages
    # what moving the rows costs, from there what each stage adds
    scan = {s: (graph_ms(lambda: rc.roll_minmax(x, s), PROBE_GRAPH_LAUNCHES),
                graph_ms(lambda: rc.roll_kv(x, x1, s), PROBE_GRAPH_LAUNCHES))
            for s in (0, 10, 40, 80, 160)}
    log(f"[11] register kernels, device ms by stage count (W {w}, m {m}): "
        + ", ".join(f"S {s}: minmax {a:.4f} kv {b:.4f}"
                    for s, (a, b) in scan.items()))
    e_mm, e_kv = (w * m * st * a / (dev_ms[n] * 1e-3)
                  for a, n in ((1, "roll_minmax"), (2, "roll_kv")))
    for line in prc.floor_lines(e_mm, e_kv, w, m, resolve_ms):
        log(f"[11] {line} (phase 5)" if "measured" in line
            else f"[11] {line}")
    src = "horizonator_tpu_torch/kernels/csrc/roll_ceiling.cu"
    out = []
    for n in calls:
        kv = "kv" in n
        runs = gen_launches if n.endswith("smem") else launches
        out.append(kernel_entry(
            n, src, "benchmarks/profile_roll_ceiling.py:" + ("62" if kv
                                                            else "38"),
            runs[n], err[n], dev_ms[n], t_kv_p if kv else t_mm_p, *work[n],
            int32_rate))
    return out


def resolve_edge_cases():
    """(name, rows y (W, K) float32, H): the shapes and columns on which a
    resolve's index arithmetic can go wrong, from seeded numpy."""
    rng = np.random.default_rng(13)

    def rows(w, k, h):
        return (h * (0.5 + 0.4 * rng.standard_normal((w, k)))).astype(
            np.float32)

    cases = [("H 100", rows(16, 300, 100), 100),
             ("H 1023", rows(8, 129, 1023), 1023),
             ("K 129, H 130", rows(8, 129, 130), 130)]
    for k in (1, 2):
        y = rows(12, k, 64)
        y[0], y[1], y[2] = 70.0, -3.0, 17.0     # sky, covered, a pixel row
        cases.append((f"K {k}", y, 64))
    y = rows(6, 40, 128)
    y[0] = 128.0 + 5.0 * rng.random(40)         # all sky: idx K everywhere
    y[1, 0] = -2.0                              # covered from sample 0
    y[2, 0] = 0.0                               # key 0 equals threshold 0
    y[3] = 127.0                                # one crossing, the last row
    cases.append(("sky and covered columns", y, 128))
    # keys at and below the image top: exact negative multiples of 256 and
    # 1/256 steps between them
    y = (rng.integers(-8, 100, (10, 64)).astype(np.float32)
         - rng.integers(0, 2, (10, 64)) * rng.integers(0, 256, (10, 64))
         / np.float32(256.0)).astype(np.float32)
    y[:, :8] = np.sort(y[:, :8], axis=1)[:, ::-1]
    cases.append(("negative keys", y, 96))
    cases.append(("thresholds equal to keys",
                  rng.integers(0, 64, (10, 80)).astype(np.float32), 64))
    # a long plateau, a cliff owning > 256 rows, a plateau again, a ramp
    y = np.empty((4, 600), np.float32)
    y[:, :200] = 1000.25
    y[:, 200:330] = 20.5
    y[:, 330:] = 20.5 - np.arange(270, dtype=np.float32) * 0.07
    y[1, 100] = 700.0                           # a dip inside the plateau
    y[2, 199] = 300.0
    y[3] += rng.random(600).astype(np.float32) * 0.01
    cases.append(("cliff beside a plateau", y, 1024))
    return cases


def edge_phase(dev):
    """Phase 13: both resolve entries against the plain version at the edge
    shapes, in both alpha regimes, bitwise."""
    from horizonator_tpu_torch.kernels.resolve import (max_k, resolve,
                                                       resolve_plain,
                                                       resolve_textured)
    rng = np.random.default_rng(14)
    names = []
    cases = resolve_edge_cases()
    # the most keys that fit a block's shared memory, and one more
    for textured in (False, True):
        k = max_k(64, textured)
        y_np = (64.0 * rng.random((2, k + 1))).astype(np.float32)
        cases.append((f"K at the {'textured ' * textured}limit", y_np[:, :k],
                      64))
        y = torch.from_numpy(y_np).to(dev)
        try:
            if textured:
                resolve_textured(y, y.to(torch.int32), 64, 1023.0, True)
            else:
                resolve(y, 64, 1023.0, True)
        except ValueError as e:
            if str(k) not in str(e):
                fail(f"the K limit's message does not name {k}: {e}")
        else:
            fail(f"K {k + 1} above the limit did not raise")
    for name, y_np, h in cases:
        y = torch.from_numpy(np.ascontiguousarray(y_np)).to(dev)
        tex = torch.from_numpy(rng.integers(
            1, 1 << 24, y_np.shape, dtype=np.int32)).to(dev)
        for amax, int_first in ((1023.0, True), (32767.0, False)):
            ref = resolve_plain(y, h, amax, int_first, tex=tex)
            entries = [("resolve", lambda: resolve(y, h, amax, int_first))]
            if y.shape[1] <= max_k(h, True):    # the textured limit is lower
                entries.append(("textured resolve", lambda: resolve_textured(
                    y, tex, h, amax, int_first)))
            for entry, fn in entries:
                got = fn()
                torch.cuda.synchronize()
                for what, r, g in zip(("idx", "alpha", "ok", "tex"), ref, got):
                    if not torch.equal(g, r):
                        fail(f"{entry} {what} != plain at edge case "
                             f"'{name}' (amax {amax:g}): "
                             f"{int((g != r).sum())} differ")
        names.append(f"{name} {tuple(y_np.shape)}")
    log(f"[13] resolve and textured resolve == plain bitwise (idx, alpha, "
        f"ok, tex), amax 1023 int-first and amax 32767 float-first, at: "
        + "; ".join(names) + "; one key above either limit raises")


def pcol_fscal(geo, p):
    """The march wrappers' inputs from a crossing geometry: (W, 8) float32
    per-column constants and the (4,) scalars ((B, W, 8) and (B, 4) for a
    batch)."""
    pcol = torch.stack([geo.a, geo.t, geo.e, geo.scale, geo.axis0.float(),
                        geo.sign.float(), geo.j_dom.float(),
                        torch.zeros_like(geo.a)], -1).contiguous()
    return pcol, torch.stack([p.viewer_z, p.znear, p.zfar, p.curv], -1)


def march_edge_cases():
    """(name, n, viewer i, j, az0, az1 deg, W, K, znear, zfar, what must
    hold): the shapes and columns on which a march's thread mapping can go
    wrong. ``what``: "j_dom" / "i_dom" (every column row- or column-
    dominant), "mixed" (both within the first 32 columns), "edge" (columns
    rewritten so that positions reach n-1 exactly), "far" (no valid sample
    from step 32 on), or None."""
    return [
        ("W 1, K 1", 64, 31.4, 30.7, 10.0, 11.0, 1, 1, 10.0, 8000.0, None),
        ("W 31, K 2", 64, 31.4, 30.7, -180.0, 180.0, 31, 2, 10.0, 8000.0,
         None),
        ("W 33, K 31", 64, 31.4, 30.7, -180.0, 180.0, 33, 31, 100.0, 8000.0,
         None),
        ("W 37, K 33, n 100", 100, 48.3, 51.9, -180.0, 180.0, 37, 33, 100.0,
         8000.0, None),
        ("W 37, K 129, n 100", 100, 48.3, 51.9, -180.0, 180.0, 37, 129,
         100.0, 8000.0, None),
        ("W 33, K 577, n 1210", 1210, 604.6, 605.2, -180.0, 180.0, 33, 577,
         100.0, 60000.0, None),
        ("octant boundary within 32 columns", 100, 50.2, 49.7, 38.0, 41.0,
         37, 64, 100.0, 8000.0, "mixed"),
        ("all row-dominant", 100, 50.2, 49.7, -10.0, 10.0, 64, 65, 100.0,
         8000.0, "j_dom"),
        ("all column-dominant", 100, 50.2, 49.7, 80.0, 100.0, 64, 65, 100.0,
         8000.0, "i_dom"),
        ("window across +-180 deg", 100, 50.2, 49.7, 170.0, -170.0, 40, 64,
         100.0, 8000.0, None),
        ("viewer in a corner", 100, 1.3, 97.8, -180.0, 180.0, 70, 129, 100.0,
         20000.0, None),
        ("viewer on a grid line", 64, 32.0, 20.0, -180.0, 180.0, 64, 64,
         100.0, 8000.0, None),
        ("pos reaches n-1", 64, 31.4, 30.7, -180.0, 180.0, 37, 64, 50.0,
         8000.0, "edge"),
        ("zfar within the first steps", 100, 50.2, 49.7, -180.0, 180.0, 96,
         129, 100.0, 500.0, "far"),
        ("znear above the first crossings", 100, 50.2, 49.7, -180.0, 180.0,
         33, 129, 1000.0, 8000.0, None),
    ]


def march_edge_phase(dev):
    """Phase 14: both march entries against the plain version at the edge
    shapes, with cell and half-cell color planes, bitwise."""
    from horizonator_tpu_torch.kernels.window_march import (march,
                                                            march_plain,
                                                            march_textured)
    from horizonator_tpu_torch.render import make_params
    from horizonator_tpu_torch.render.crossing import crossing_geometry
    rng = np.random.default_rng(15)
    names = []
    for name, n, vi, vj, az0, az1, w, k, znear, zfar, what in \
            march_edge_cases():
        dem = torch.from_numpy((2000.0 * rng.random((n, n))).astype(
            np.float32)).to(dev)
        p = make_params(device=dev, viewer_cell_i=vi, viewer_cell_j=vj,
                        viewer_z=900.0,
                        cos_viewer_lat=math.cos(math.radians(LAT)),
                        az_rad0=math.radians(az0), az_rad1=math.radians(az1),
                        znear=znear, zfar=zfar, znear_color=znear,
                        zfar_color=zfar, curv=6.8e-8)
        geo = crossing_geometry(p, width=w, cells_per_deg=CPD)
        pcol, fscal = pcol_fscal(geo, p)
        if what == "edge":
            # columns 0-3 march along line 0.., their position on it n-1
            # at every step (t = 0) or exactly at step 10 (t = 0.5), as
            # row- and as column-dominant columns
            pcol[:4, 4], pcol[:4, 5] = 0.0, 1.0
            pcol[:4, 0] = torch.tensor([n - 1.0, n - 1.0, n - 6.0, n - 6.0])
            pcol[:4, 1] = torch.tensor([0.0, 0.0, 0.5, 0.5])
            pcol[:4, 6] = torch.tensor([0.0, 1.0, 0.0, 1.0])
        ref = march_plain(dem, pcol, fscal, k)
        valid = ref > -1e30
        jd = pcol[:32, 6] != 0.0
        holds = {None: True, "mixed": bool(jd.any() and not jd.all()),
                 "j_dom": bool((pcol[:, 6] != 0.0).all()),
                 "i_dom": bool((pcol[:, 6] == 0.0).all()),
                 "far": bool(valid[:, :32].any()
                             and not valid[:, 32:].any())}
        if what == "edge":
            m = torch.arange(k, dtype=torch.float32, device=dev)[None, :]
            at_edge = (pcol[:, :1] + m * pcol[:, 1:2] == n - 1.0) & valid
            holds["edge"] = bool(at_edge[:4].any(1).all())
        if not holds[what]:
            fail(f"march edge case '{name}' does not show its edge")
        got = march(dem, pcol, fscal, k)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"window march != plain at edge case '{name}': "
                 f"{int((got != ref).sum())} samples differ")
        for s in (1, 2):
            colors = torch.from_numpy(rng.integers(
                0, 1 << 24, (s * n, s * n), dtype=np.int32)).to(dev)
            ref_t, ref_c = march_plain(dem, pcol, fscal, k, colors, s)
            got_t, got_c = march_textured(dem, pcol, fscal, k, colors, s)
            torch.cuda.synchronize()
            if not (torch.equal(got_t, ref) and torch.equal(ref_t, ref)):
                fail(f"textured march (s {s}) samples != untextured at "
                     f"edge case '{name}'")
            if not torch.equal(got_c, ref_c):
                fail(f"textured march (s {s}) colors != plain at edge case "
                     f"'{name}': {int((got_c != ref_c).sum())} differ")
            if (got_c[~valid] != 0).any():
                fail(f"textured march (s {s}) colors an invalid sample at "
                     f"edge case '{name}'")
        names.append(f"{name} ({w}, {k}) {float(valid.float().mean()):.2f} "
                     f"valid")
    log("[14] window march and textured march (cell and half-cell planes) "
        "== plain bitwise (samples incl. NEG_BIG, colors incl. 0 at invalid "
        "samples) at: " + "; ".join(names))


def cli_phase(tiles):
    """Phase 12: the CLI in-process on phase 6's tiles, then the API's
    horizon() and pick()."""
    from horizonator_tpu_torch import cli, horizonator
    from horizonator_tpu_torch.geometry import project
    from horizonator_tpu_torch.kernels.resolve import resolve
    from horizonator_tpu_torch.kernels.window_march import march
    with tempfile.TemporaryDirectory() as td:
        pdf, npy = os.path.join(td, "pano.pdf"), os.path.join(td, "pano.npy")
        march.launches = resolve.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--width", str(W), "--height", str(H), "--image", pdf,
                       "--ranges", npy, "--dirdems", tiles, "34.4", "-117.6",
                       "0", "180"])
        cli_s = time.perf_counter() - t0
        launches = {"window_march": march.launches,
                    "resolve": resolve.launches}
        if rc != 0 or min(launches.values()) < 1:
            fail(f"CLI rc {rc}, launches {launches}")
        r_cli = np.load(npy)
        with open(pdf, "rb") as f:
            head = f.read(8)
        pdf_mb = os.path.getsize(pdf) / 1e6
    h = horizonator(34.4, -117.6, W, H, dir_dems=tiles,
                    render_radius_m=40000.0)
    r_api = h.render(-180, 180)[1]
    if not np.array_equal(r_cli, r_api):
        fail(f"CLI ranges != API render: {int((r_cli != r_api).sum())} "
             f"pixels differ")
    if not head.startswith(b"%PDF"):
        fail(f"CLI wrote no PDF: {head!r}")
    log(f"[12] CLI {W}x{H} full circle -> .pdf ({pdf_mb:.1f} MB) + .npy in "
        f"{cli_s:.2f} s: rc 0, launches {launches}, ranges == API render "
        f"bitwise")
    march.launches = 0
    az, tan_el = h.horizon(-180, 180)
    if march.launches < 1:
        fail("horizon() did not launch the march kernel")
    if az.shape != (W,) or not np.isfinite(tan_el).all():
        fail(f"bad horizon {az.shape} {tan_el.shape}")
    ys, xs = np.nonzero(r_api > 2000.0)
    k = len(ys) // 2
    x, y = int(xs[k]), int(ys[k])
    lat, lon = h.pick(x, y)
    px = float(project(34.4, math.cos(math.radians(34.4)), -117.6,
                       h.viewer_z, lat, lon, 0.0, math.radians(-180.0),
                       math.radians(180.0), W, H)[0])
    if abs(px - x) > 0.5:
        fail(f"pick({x}, {y}) -> ({lat}, {lon}) projects to column {px}")
    log(f"[12] horizon(-180, 180): {W} columns, max tan_el "
        f"{float(tan_el.max()):.4f}, march launched {march.launches}; "
        f"pick({x}, {y}) at {float(r_api[y, x]):.1f} m -> ({lat:.6f}, "
        f"{lon:.6f}), projects to column {px:.3f}")


def annulus_cells(n, vi, vj, d_lo, d_hi, cell_n, lat, rows=None):
    """Cells of an (n, n) grid with cell size cell_n (north) whose distance
    from the viewer lies in [d_lo - one cell diagonal, d_hi]: the cells a
    march of that band must read (d_lo 0: the disk within zfar); ``rows``
    (a range): those of a row band alone."""
    cell_e = cell_n * math.cos(math.radians(lat))
    i = ((np.arange(n) - vi) * cell_e) ** 2
    j = ((np.arange(n)[rows or slice(None)] - vj) * cell_n) ** 2
    d2 = j[:, None] + i[None, :]
    lo = max(0.0, d_lo - math.hypot(cell_n, cell_e))
    return int(((d2 <= d_hi * d_hi) & (d2 >= lo * lo)).sum())


def lod_level_marches(pyr, p, plan, cpyr=None, *, width=LOD_W,
                      cpd=LOD_CPD, lat_hint=LOD_LAT, lat=LOD_LAT):
    """Each level's window-march launch of a LOD render, on the crop,
    geometry and budget that march_lod gives it, against the plain version:
    samples (and colors) bitwise. Returns per level a dict of its shape,
    its valid share, the bytes and operations of its bound, and ``call``,
    the wrapper call, for timing. ``lat``: the viewer's, for the bound's
    cell count."""
    from horizonator_tpu_torch.kernels.window_march import (march,
                                                            march_plain,
                                                            march_textured)
    from horizonator_tpu_torch.render import lod
    from horizonator_tpu_torch.render.texture import ColorPlanes2x
    from horizonator_tpu_torch.render.window import step_budget
    levels = []
    for spec in plan:
        dem_c, p_c, colors_c, geo = lod.level_inputs(
            pyr, p, spec, width=width, cells_per_deg=cpd,
            lat_hint_deg=lat_hint, color_pyramid=cpyr)
        pcol, fscal = pcol_fscal(geo, p_c)
        c = dem_c.shape[0]
        k_lim = step_budget(spec.k_lo + spec.k_len, c)
        cell_n = 6371000.0 * math.pi / 180.0 / (cpd / 2 ** spec.level)
        cells = annulus_cells(c, float(p_c.viewer_cell_i),
                              float(p_c.viewer_cell_j), spec.d_lo,
                              spec.d_hi, cell_n, lat)
        lanes = width * k_lim
        if colors_c is None:
            def call(d=dem_c, pc=pcol, fs=fscal, k=k_lim):
                return march(d, pc, fs, k)
            ref, got = march_plain(dem_c, pcol, fscal, k_lim), call()
            torch.cuda.synchronize()
            same, valid = torch.equal(got, ref), ref > -1e30
            nbytes, ops = 4 * cells + 4 * lanes, MARCH_FLOPS * lanes
        else:
            plane, s = ((colors_c.full_packed, 2)
                        if isinstance(colors_c, ColorPlanes2x)
                        else (colors_c, 1))

            def call(d=dem_c, pc=pcol, fs=fscal, k=k_lim, pl=plane, ss=s):
                return march_textured(d, pc, fs, k, pl, ss)
            ref, got = march_plain(dem_c, pcol, fscal, k_lim, plane, s), call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            valid = ref[0] > -1e30
            if (ref[1][~valid] != 0).any():
                fail(f"LOD level {spec.level}: an invalid sample has a color")
            nbytes = 4 * (1 + s * s) * cells + 8 * lanes
            ops = MARCH_TEX_FLOPS * lanes
        if not same:
            fail(f"LOD level {spec.level} march (crop {c}, K {k_lim}, "
                 f"{'textured' if colors_c is not None else 'untextured'})"
                 f" != plain")
        levels.append(dict(level=spec.level, crop=c, grid=pyr[
            spec.level].shape[0], k=k_lim, band=(spec.d_lo, spec.d_hi),
            valid=float(valid.float().mean()), call=call, bytes=nbytes,
            ops=ops))
    return levels


def lod_timings(levels, tag):
    """Graph-replay device ms of each level's march launch against its
    bound; logs them and returns the list of ms."""
    out = []
    for lv in levels:
        ms = graph_ms(lv["call"], GRAPH_LAUNCHES)
        b_ms, b_by = bound(lv["bytes"], lv["ops"], FP32_OPS_PER_S)
        out.append(ms)
        log(f"[{tag}] level {lv['level']}: grid {lv['grid']}, crop "
            f"{lv['crop']}, K {lv['k']}, band {lv['band'][0]:.0f}-"
            f"{lv['band'][1]:.0f} m, valid {lv['valid']:.3f}; device ms "
            f"{ms:.4f}, bound {b_ms:.5f} ({b_by}), share "
            f"{100 * b_ms / ms:.1f}%")
    return out


def lod_phases(dev, card, int32_rate, profile_dir=None):
    """Phases 15 and 16: the LOD scene at suite config 3's and 9's
    per-viewpoint shape; returns {kernel name: LOD record} for the JSON
    line."""
    from horizonator_tpu_torch.kernels.resolve import (resolve,
                                                       resolve_plain,
                                                       resolve_textured)
    from horizonator_tpu_torch.kernels.window_march import (march,
                                                            march_textured)
    from horizonator_tpu_torch.render import lod, make_params, \
        render_panorama
    from horizonator_tpu_torch.render.raymarch import (horizon_rows,
                                                       resolve_to_image)
    from horizonator_tpu_torch.render.resolve_window import alpha_quantum
    from horizonator_tpu_torch.render.texture import prepare_color_planes
    counters = (march, resolve, march_textured, resolve_textured)

    def reset():
        for fn in counters:
            fn.launches = 0

    def counts(*fns):
        return {fn.__name__: fn.launches for fn in fns}

    # -- 15. the LOD scene ---------------------------------------------------
    t0 = time.perf_counter()
    n = LOD_N
    dem_np = bench_dem(seed=15, n=n)
    plan = lod.lod_plan(LOD_ZFAR, LOD_W, LOD_CPD, LOD_LAT, n)
    nlev = 1 + max(s.level for s in plan)
    k_tot = 4 + sum(s.k_len for s in plan)
    if len(plan) != LOD_LEVELS:
        fail(f"LOD plan has {len(plan)} levels, not {LOD_LEVELS}: {plan}")
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dem = torch.from_numpy(dem_np).to(dev)
    pyr = lod.build_pyramid(dem, nlev)
    torch.cuda.synchronize()
    pyr_mb = sum(x.nbytes for x in pyr[1:]) / 1e6
    pyr_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e6
    pyr_cpu = lod.build_pyramid(torch.from_numpy(dem_np), nlev)
    for lvl, (a, b) in enumerate(zip(pyr, pyr_cpu)):
        if not torch.equal(a.cpu(), b):
            fail(f"pyramid level {lvl} on the card != on the CPU")

    def lod_params(i=0):
        return make_params(
            device=dev, viewer_cell_i=n / 2 + 3 * i, viewer_cell_j=n / 2 - i,
            viewer_z=LOD_VZ, cos_viewer_lat=math.cos(math.radians(LOD_LAT)),
            az_rad0=math.radians(-180.0), az_rad1=math.radians(180.0),
            znear=100.0, zfar=LOD_ZFAR, znear_color=100.0,
            zfar_color=LOD_ZFAR)

    p = lod_params()
    levels = lod_level_marches(pyr, p, plan)
    log(f"[15] LOD plan {LOD_W}x{LOD_H}, zfar {LOD_ZFAR:.0f} m, SRTM1 "
        f"{n}^2: {len(plan)} levels, {k_tot} lanes; pyramid on the card == "
        f"on the CPU bitwise ({pyr_mb:.1f} MB above the DEM, peak "
        f"{pyr_peak:.1f} MB with it); each level's march == plain bitwise: "
        + ", ".join(f"L{lv['level']} crop {lv['crop']} of {lv['grid']} K "
                    f"{lv['k']}" for lv in levels))
    rkw = dict(width=LOD_W, height=LOD_H, nsteps=1, cells_per_deg=LOD_CPD,
               lat_hint_deg=LOD_LAT, sampler="lod", lod_plan=plan)
    reset()
    img, rng, guard = render_panorama(pyr, p, with_dropped=True, **rkw)
    torch.cuda.synchronize()
    launches = counts(march, resolve)
    if launches != {"march": nlev, "resolve": 1}:
        fail(f"LOD render launches {launches}, want {nlev} marches and one "
             f"resolve")
    vis = float((rng > 0).float().mean())
    if guard.tolist() != [0, 0] or not 0.05 < vis < 0.95 \
            or img.shape != (LOD_H, LOD_W, 3):
        fail(f"bad LOD render: guard {guard.tolist()}, visible {vis}, "
             f"{tuple(img.shape)}")
    if float(rng.max()) < plan[2].d_lo:
        fail(f"LOD render sees nothing past level 1's band: max range "
             f"{float(rng.max())}")
    img_p, rng_p = render_panorama(pyr, p, plain=True, **rkw)
    if not (torch.equal(img, img_p) and torch.equal(rng, rng_p)):
        fail("LOD kernel render != plain render")
    tanel, _, _ = lod.march_lod(pyr, p, width=LOD_W, plan=plan,
                                cells_per_deg=LOD_CPD, lat_hint_deg=LOD_LAT)
    y_lod = horizon_rows(tanel, p, width=LOD_W, height=LOD_H).contiguous()
    amax, int_first = alpha_quantum(y_lod.shape[1], LOD_H)
    out_k = resolve(y_lod, LOD_H, amax, int_first)
    out_p = resolve_plain(y_lod, LOD_H, amax, int_first)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
        fail(f"LOD resolve at K {y_lod.shape[1]} != plain")
    log(f"[15] LOD render: visible {vis:.4f}, max range "
        f"{float(rng.max()):.0f} m, launches per render {launches}, image "
        f"and ranges == plain-version render bitwise; resolve at "
        f"{tuple(y_lod.shape)} -> H {LOD_H} == plain bitwise")
    params = [lod_params(i) for i in range(RENDERS + 2)]
    ms_lod = cuda_ms(lambda i: render_panorama(pyr, params[i], **rkw),
                     RENDERS)
    ms_lod_p = cuda_ms(lambda i: render_panorama(pyr, params[i], plain=True,
                                                 **rkw), 5, warmup=1)
    log(f"[15] LOD ms/viewpoint (median, CUDA events): kernels {ms_lod:.3f} "
        f"over {RENDERS} camera-moved renders, plain versions "
        f"{ms_lod_p:.3f} over 5")
    # where the LOD frame's time goes, step by step (kernel path)
    lkw = dict(width=LOD_W, cells_per_deg=LOD_CPD, lat_hint_deg=LOD_LAT)
    _, dists_lod, az_lod = lod.march_lod(pyr, p, plan=plan, **lkw)
    steps = {
        "level inputs (band, crop gather, geometry), all levels":
            lambda i: [lod.level_inputs(pyr, p, s, **lkw) for s in plan],
        "march_lod (inputs, kernels, near band, guards, concat)":
            lambda i: lod.march_lod(pyr, p, plan=plan, **lkw),
        "row map (atan)":
            lambda i: horizon_rows(tanel, p, width=LOD_W, height=LOD_H),
        "resolve + tail (resolve_to_image)":
            lambda i: resolve_to_image(tanel, dists_lod.d_of, az_lod, p,
                                       width=LOD_W, height=LOD_H),
    }
    for name, fn in steps.items():
        log(f"[15] step {name}: {cuda_ms(fn, 20):.4f} ms")
    march_ms = lod_timings(levels, 15)
    r_bytes = y_lod.nbytes + 9 * LOD_W * LOD_H
    r_ops = LOD_W * (4 * y_lod.shape[1] + 12 * LOD_H)
    res_ms = graph_ms(lambda: resolve(y_lod, LOD_H, amax, int_first),
                      GRAPH_LAUNCHES)
    b_ms, b_by = bound(r_bytes, r_ops, int32_rate)
    log(f"[15] LOD resolve {tuple(y_lod.shape)} -> H {LOD_H}: device ms "
        f"{res_ms:.4f}, bound {b_ms:.5f} ({b_by}), share "
        f"{100 * b_ms / res_ms:.1f}%")
    in_frame = {"march": None, "resolve": None}
    if profile_dir:
        per = {"window_march_kernel<false": [], "resolve_kernel<false": []}
        out = os.path.join(profile_dir, "profile_render_lod.txt")
        busy, _ = profile_renders(
            lambda i: render_panorama(pyr, params[i], **rkw), 5, card, out,
            f"5 LOD renders {LOD_W}x{LOD_H}", tuple(per), per)
        m = per["window_march_kernel<false"]
        in_frame = {"march": [statistics.mean(m[lv::nlev])
                              for lv in range(nlev)],
                    "resolve": statistics.mean(per["resolve_kernel<false"])}
        log(f"[15] profile: device busy {busy:.3f} ms per LOD render of "
            f"{ms_lod:.3f} ms ({100 * busy / ms_lod:.1f}%); in-frame device "
            f"ms per level's march "
            + ", ".join(f"L{lv} {t:.4f}" for lv, t in
                        enumerate(in_frame["march"]))
            + f", resolve {in_frame['resolve']:.4f}; table in {out}")
    log(f"[t] phase 15: {time.perf_counter() - t0:.1f} s")

    # -- 16. the textured LOD scene ------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    cells = torch.randint(0, 256, (3, n, n), generator=gen, device=dev,
                          dtype=torch.uint8).float()
    half = prepare_color_planes(torch.randint(
        0, 256, (3, 2 * n, 2 * n), generator=gen, device=dev,
        dtype=torch.uint8).float())
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cpyr = {"cell": lod.build_color_pyramid(cells, nlev, n),
            "half-cell": lod.build_color_pyramid(half, nlev, n)}
    torch.cuda.synchronize()
    cpyr_peak = (torch.cuda.max_memory_allocated() - mem0) / 1e6
    cpyr_mb = {k: sum(x.nbytes for x in v[1:]) / 1e6 for k, v in cpyr.items()}
    del cells
    tkw = dict(rkw, textured=True)
    tex_levels = {}
    for name, cp in cpyr.items():
        tex_levels[name] = lod_level_marches(pyr, p, plan, cp)
        reset()
        img_t, rng_t, guard_t = render_panorama(pyr, p, color_planes=cp,
                                                with_dropped=True, **tkw)
        torch.cuda.synchronize()
        t_launches = counts(march_textured, resolve_textured)
        if t_launches != {"march_textured": nlev, "resolve_textured": 1}:
            fail(f"textured LOD render ({name}) launches {t_launches}")
        img_tp, rng_tp = render_panorama(pyr, p, color_planes=cp, plain=True,
                                         **tkw)
        if not (torch.equal(img_t, img_tp) and torch.equal(rng_t, rng_tp)):
            fail(f"textured LOD kernel render ({name}) != plain render")
        if not torch.equal(rng_t, rng) or guard_t.tolist() != [0, 0]:
            fail(f"textured LOD ranges ({name}) != untextured, or guard "
                 f"{guard_t.tolist()}")
        if int(img_t[..., 1][rng_t > 0].to(torch.int64).sum()) == 0:
            fail(f"textured LOD render ({name}) carries no green")
        log(f"[16] textured LOD render ({name} level 0): launches "
            f"{t_launches}, each level's textured march == plain bitwise, "
            f"image and ranges == plain-version render bitwise, ranges == "
            f"phase 15 bitwise")
    cp = cpyr["half-cell"]
    ms_tex = cuda_ms(lambda i: render_panorama(pyr, params[i],
                                               color_planes=cp, **tkw),
                     RENDERS)
    ms_tex_p = cuda_ms(lambda i: render_panorama(
        pyr, params[i], color_planes=cp, plain=True, **tkw), 5, warmup=1)
    log(f"[16] textured LOD ms/viewpoint (half-cell level 0, median, CUDA "
        f"events): kernels {ms_tex:.3f} over {RENDERS}, plain versions "
        f"{ms_tex_p:.3f} over 5; color pyramids above level 0: cell "
        f"{cpyr_mb['cell']:.1f} MB, half-cell {cpyr_mb['half-cell']:.1f} "
        f"MB (peak {cpyr_peak:.1f} MB building both); half-cell level 0 "
        f"{half.full_packed.nbytes / 1e6:.1f} MB")
    tex_ms = lod_timings(tex_levels["half-cell"], 16)
    tanel_t, _, _, tex = lod.march_lod(pyr, p, width=LOD_W, plan=plan,
                                       cells_per_deg=LOD_CPD,
                                       lat_hint_deg=LOD_LAT, color_pyramid=cp)
    if not torch.equal(tanel_t, tanel):
        fail("textured LOD tangents != untextured")
    tres_ms = graph_ms(lambda: resolve_textured(y_lod, tex, LOD_H, amax,
                                                int_first), GRAPH_LAUNCHES)
    b_ms, b_by = bound(r_bytes + tex.nbytes + 4 * LOD_W * LOD_H,
                       r_ops + LOD_W * LOD_H, int32_rate)
    log(f"[16] textured LOD resolve {tuple(y_lod.shape)} -> H {LOD_H}: "
        f"device ms {tres_ms:.4f}, bound {b_ms:.5f} ({b_by}), share "
        f"{100 * b_ms / tres_ms:.1f}%")
    t_in_frame = {"march": None, "resolve": None}
    if profile_dir:
        per = {"window_march_kernel<true": [], "resolve_kernel<true": []}
        out = os.path.join(profile_dir, "profile_render_lod_textured.txt")
        busy, _ = profile_renders(
            lambda i: render_panorama(pyr, params[i], color_planes=cp,
                                      **tkw), 5, card, out,
            f"5 textured LOD renders {LOD_W}x{LOD_H}", tuple(per), per)
        m = per["window_march_kernel<true"]
        t_in_frame = {"march": [statistics.mean(m[lv::nlev])
                                for lv in range(nlev)],
                      "resolve": statistics.mean(per["resolve_kernel<true"])}
        log(f"[16] profile: device busy {busy:.3f} ms per textured LOD "
            f"render of {ms_tex:.3f} ms ({100 * busy / ms_tex:.1f}%); "
            f"in-frame device ms per level's march "
            + ", ".join(f"L{lv} {t:.4f}" for lv, t in
                        enumerate(t_in_frame["march"]))
            + f", resolve {t_in_frame['resolve']:.4f}; table in {out}")
    log(f"[t] phase 16: {time.perf_counter() - t0:.1f} s")
    del cpyr, cp, half, pyr, dem, tex
    return {
        "window_march": dict(lod_launches=launches["march"],
                             lod_ms=march_ms,
                             lod_in_frame_ms=in_frame["march"]),
        "resolve": dict(lod_launches=launches["resolve"], lod_ms=res_ms,
                        lod_in_frame_ms=in_frame["resolve"]),
        "window_march_textured": dict(
            lod_launches=t_launches["march_textured"], lod_ms=tex_ms,
            lod_in_frame_ms=t_in_frame["march"]),
        "resolve_textured": dict(
            lod_launches=t_launches["resolve_textured"], lod_ms=tres_ms,
            lod_in_frame_ms=t_in_frame["resolve"]),
    }


def srtm1_grid():
    """The synthetic SRTM1 tile N34W118 as int16 elevations, row 0 = north
    (the .hgt order): ridges and a peak NE of 34.5 N, 117.5 W."""
    from horizonator_tpu_torch.dem import hgt
    edge = hgt.SRTM1_EDGE
    la = (35.0 - np.arange(edge) / (edge - 1))[:, None]
    lo = (-118.0 + np.arange(edge) / (edge - 1))[None, :]
    z = (700.0 + 600.0 * np.sin(lo * 9.1) * np.cos(la * 7.3)
         + 250.0 * np.sin(lo * 41.0 + 0.7) * np.cos(la * 37.0)
         + 1500.0 * np.exp(-((la - 34.62) ** 2 + (lo + 117.35) ** 2)
                           / 0.004))
    return np.round(np.maximum(z, 0.0)).astype(np.int16)


def write_srtm1_tile(d):
    """srtm1_grid() written as N34W118.hgt into d."""
    from horizonator_tpu_torch.dem import hgt
    hgt.write_hgt(os.path.join(d, hgt.hgt_filename(34, -118)), srtm1_grid())


def srtm1_phase(dev, int32_rate):
    """Phase 17: the API and the CLI on an SRTM1 tile at the default zfar,
    which needs the LOD march: each level's march, the resolve and the
    render against their plain versions at the API's shapes; skyline
    against horizon and its full-budget march against the plain version,
    debug_fill, and --horizon-out with and without --image."""
    import csv
    from horizonator_tpu_torch import cli, horizonator
    from horizonator_tpu_torch.kernels.resolve import (resolve,
                                                       resolve_plain,
                                                       resolve_textured)
    from horizonator_tpu_torch.kernels.window_march import (march,
                                                            march_plain,
                                                            march_textured)
    from horizonator_tpu_torch.render import lod, render_panorama
    from horizonator_tpu_torch.render.crossing import crossing_geometry
    from horizonator_tpu_torch.render.raymarch import horizon_rows
    from horizonator_tpu_torch.render.resolve_window import alpha_quantum
    from horizonator_tpu_torch.render.window import step_budget
    t0 = time.perf_counter()
    lat, lon = 34.5, -117.5
    with tempfile.TemporaryDirectory() as td:
        write_srtm1_tile(td)
        h = horizonator(lat, lon, W, H, SRTM1=True, dir_dems=td, device=dev)
        march.launches = resolve.launches = 0
        img, rng = h.render(-180, 180)
        launches = {"march": march.launches, "resolve": resolve.launches}
        _, sampler, nsteps, plan, _ = h._batch_render_plan(100.0, 40000.0)
        if sampler != "lod" or h._pyramid is None \
                or len(plan) != SRTM1_LEVELS:
            fail(f"SRTM1 API render at the default zfar did not take LOD: "
                 f"{sampler}, {nsteps} steps, plan {plan}")
        if launches != {"march": len(plan), "resolve": 1}:
            fail(f"SRTM1 API render launches {launches}")
        vis = float((rng > 0).mean())
        if img.shape != (H, W, 3) or not 0.05 < vis < 0.95:
            fail(f"bad SRTM1 API render {img.shape}, visible {vis}")
        # the render's kernels against their plain versions, on the API's
        # pyramid, params and plan
        cpd = h.mosaic.cells_per_deg
        p_api = h._params(-180.0, 180.0, 100.0, 40000.0, 100.0, 40000.0)
        akw = dict(width=W, cells_per_deg=cpd, lat_hint_deg=h._lat_hint())
        levels = lod_level_marches(h._pyramid, p_api, plan, width=W, cpd=cpd,
                                   lat_hint=h._lat_hint(), lat=lat)
        img_p, rng_p = render_panorama(
            h._pyramid, p_api, height=H, nsteps=nsteps, surface=h.surface,
            refine=h.refine, sampler="lod", lod_plan=plan,
            znear_hint_m=h._znear_hint(100.0), plain=True, **akw)
        if not (np.array_equal(img, img_p.cpu().numpy())
                and np.array_equal(rng, rng_p.cpu().numpy())):
            fail("SRTM1 API render != plain-version render")
        tanel = lod.march_lod(h._pyramid, p_api, plan=plan, **akw)[0]
        y_api = horizon_rows(tanel, p_api, width=W, height=H).contiguous()
        amax, int_first = alpha_quantum(y_api.shape[1], H)
        out_k = resolve(y_api, H, amax, int_first)
        out_p = resolve_plain(y_api, H, amax, int_first)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
            fail(f"SRTM1 API resolve at {tuple(y_api.shape)} -> H {H} != "
                 f"plain")
        ms = cuda_ms(lambda i: h.render(-180 + i, 180 + i), 10, warmup=1)
        pyr_mb = sum(x.nbytes for x in h._pyramid[1:]) / 1e6
        log(f"[17] SRTM1 API render {W}x{H} of {h.mosaic.grid.shape} grid "
            f"at the default zfar ({nsteps} crossing steps): LOD, "
            f"{len(plan)} levels (" + ", ".join(
                f"L{s.level} {s.d_lo:.0f}-{s.d_hi:.0f} m" for s in plan)
            + f"), launches {launches}, visible {vis:.4f}; each level's "
            f"march == plain bitwise (" + ", ".join(
                f"L{lv['level']} crop {lv['crop']} of {lv['grid']} K "
                f"{lv['k']}" for lv in levels)
            + f"), resolve {tuple(y_api.shape)} -> H {H} == plain bitwise, "
            f"image and ranges == plain-version render bitwise; {ms:.3f} ms "
            f"per render (median of 10, outputs copied to the host); "
            f"pyramid {pyr_mb:.1f} MB above the DEM")
        lod_timings(levels, 17)
        res_ms = graph_ms(lambda: resolve(y_api, H, amax, int_first),
                          GRAPH_LAUNCHES)
        b_ms, b_by = bound(y_api.nbytes + 9 * W * H,
                           W * (4 * y_api.shape[1] + 12 * H), int32_rate)
        log(f"[17] API resolve {tuple(y_api.shape)} -> H {H}: device ms "
            f"{res_ms:.4f}, bound {b_ms:.5f} ({b_by}), share "
            f"{100 * b_ms / res_ms:.1f}%")
        march.launches = 0
        sky = h.skyline(-180, 180)
        _, tan_el = h.horizon(-180, 180)
        el_err = float(np.abs(sky["el_deg"]
                              - np.degrees(np.arctan(tan_el))).max())
        if march.launches != 2:
            fail(f"skyline and horizon launches {march.launches}, want 2")
        if el_err > 1e-4 or not np.isfinite(sky["lat"]).all():
            fail(f"skyline el_deg vs horizon: {el_err} deg")
        # the skyline's march, the full budget over the whole grid
        geo = crossing_geometry(p_api, width=W, cells_per_deg=cpd)
        pcol, fscal = pcol_fscal(geo, p_api)
        n = h._dem.shape[0]
        k_sky = step_budget(nsteps, n)
        got = march(h._dem, pcol, fscal, k_sky)
        ref = march_plain(h._dem, pcol, fscal, k_sky)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"skyline march (grid {n}, K {k_sky}) != plain")
        sky_ms = graph_ms(lambda: march(h._dem, pcol, fscal, k_sky),
                          GRAPH_LAUNCHES)
        cell_n = 6371000.0 * math.pi / 180.0 / cpd
        ci, cj = h.mosaic.viewer_cell(lat, lon)
        b_ms, b_by = bound(
            4 * annulus_cells(n, ci, cj, 0.0, 40000.0, cell_n, lat)
            + 4 * W * k_sky, MARCH_FLOPS * W * k_sky, FP32_OPS_PER_S)
        log(f"[17] skyline(-180, 180) and horizon(): {W} columns, el_deg "
            f"within {el_err:.2e} deg of degrees(arctan(tan_el)); horizon "
            f"at {float(np.median(sky['dist_m'])):.0f} m (median); their "
            f"march (grid {n}, K {k_sky}) == plain bitwise, valid "
            f"{float((ref > -1e30).float().mean()):.3f}, device ms "
            f"{sky_ms:.4f}, bound {b_ms:.5f} ({b_by}), share "
            f"{100 * b_ms / sky_ms:.1f}%")
        del got, ref, tanel, y_api, out_k, out_p, img_p, rng_p
        march_textured.launches = resolve_textured.launches = 0
        img_d, rng_d = h.render(-180, 180, zfar=30000.0,
                                debug_fill="wireframe")
        d_launches = {"march_textured": march_textured.launches,
                      "resolve_textured": resolve_textured.launches}
        g = img_d[rng_d > 0][:, 1].astype(np.int64)
        if min(d_launches.values()) < 1 or g.max() < 150 or g.min() > 60:
            fail(f"debug_fill render: launches {d_launches}, green "
                 f"{g.min()}-{g.max()}")
        log(f"[17] render(zfar 30 km, debug_fill='wireframe'): window "
            f"sampler, launches {d_launches}, lattice green {g.max()} over "
            f"terrain {g.min()}")
        pdf, gj = os.path.join(td, "x.pdf"), os.path.join(td, "x.geojson")
        march.launches = resolve.launches = 0
        t1 = time.perf_counter()
        rc = cli.main(["--SRTM1", "--dirdems", td, "--width", str(W),
                       "--height", str(H), "--image", pdf, "--horizon-out",
                       gj, str(lat), str(lon), "0", "180"])
        cli_s = time.perf_counter() - t1
        c_launches = {"march": march.launches, "resolve": resolve.launches}
        with open(gj) as f:
            coords = json.load(f)["features"][0]["geometry"]["coordinates"]
        with open(pdf, "rb") as f:
            head = f.read(5)
        if rc != 0 or len(coords) != W or head != b"%PDF-":
            fail(f"CLI --SRTM1 --image .pdf --horizon-out .geojson: rc {rc},"
                 f" {len(coords)} coordinates, {head!r}")
        if c_launches != {"march": len(plan) + 1, "resolve": 1}:
            fail(f"CLI launches {c_launches}: want the LOD render's and the "
                 f"skyline's")
        csv_path = os.path.join(td, "x.csv")
        rc2 = cli.main(["--SRTM1", "--dirdems", td, "--width", "1024",
                        "--horizon-out", csv_path, str(lat), str(lon), "0",
                        "180"])
        with open(csv_path) as f:
            rows = list(csv.reader(f))
        if rc2 != 0 or len(rows) != 1025 or rows[0][0] != "az_deg":
            fail(f"headless CLI --horizon-out .csv: rc {rc2}, {len(rows)} "
                 f"rows")
        log(f"[17] CLI --SRTM1 {W}x{H} -> .pdf + --horizon-out .geojson in "
            f"{cli_s:.2f} s: rc 0, launches {c_launches} (LOD render + "
            f"skyline), {len(coords)} coordinates; headless --horizon-out "
            f".csv: rc 0, {len(rows) - 1} rows")
    log(f"[t] phase 17: {time.perf_counter() - t0:.1f} s")


def batch_params(dev, vi, vj, vz, lat, az0_deg, az1_deg, znear, zfar,
                 curv=0.0):
    """A (B,) RenderParams batch from per-viewpoint sequences (or shared
    numbers), the colour ramp at the clip range."""
    from horizonator_tpu_torch.render import make_params

    def seq(x):
        return np.asarray(x, np.float64).tolist()
    return make_params(
        device=dev, viewer_cell_i=seq(vi), viewer_cell_j=seq(vj),
        viewer_z=seq(vz), cos_viewer_lat=math.cos(math.radians(lat)),
        az_rad0=np.radians(az0_deg).tolist(),
        az_rad1=np.radians(az1_deg).tolist(), znear=seq(znear),
        zfar=seq(zfar), znear_color=seq(znear), zfar_color=seq(zfar),
        curv=seq(curv))


def batch_march_edge_phase(dev):
    """Phase 18: both march entries with a batch axis against the batched
    plain version, bitwise, at B 1, 2, 3 and 65: one DEM shared by the
    batch and one per viewpoint, W 37, K 129, cell and half-cell planes
    (shared and per viewpoint), viewpoints that differ in position,
    azimuth window, viewer_z, znear, zfar and curvature; every viewpoint
    against its own unbatched launch. Then a batch whose outputs pass 2^31
    elements (330 viewpoints at 4096 x 1600), its last viewpoints against
    unbatched launches."""
    from horizonator_tpu_torch.kernels.window_march import (march,
                                                            march_plain,
                                                            march_textured)
    from horizonator_tpu_torch.render.crossing import crossing_geometry
    rng = np.random.default_rng(18)
    n, w, k = 100, 37, 129
    names = []

    def params(b, nn):
        i = np.arange(b)
        return batch_params(
            dev, 20.3 + (i * 7.1) % (nn - 40), 25.6 + (i * 5.3) % (nn - 50),
            700.0 + 37.0 * i, LAT, -180.0 + 23.0 * i,
            -90.0 + 23.0 * i + 13.0 * (i % 7),
            np.array([10.0, 100.0, 1000.0])[i % 3],
            np.array([8000.0, 2500.0, 20000.0])[i % 3],
            np.array([0.0, 6.8e-8])[i % 2])

    for b in (1, 2, 3, 65):
        p = params(b, n)
        pcol, fscal = pcol_fscal(crossing_geometry(p, width=w,
                                                   cells_per_deg=CPD), p)
        dems = {"shared DEM": torch.from_numpy((2000.0 * rng.random(
                    (n, n))).astype(np.float32)).to(dev),
                "a DEM per viewpoint": torch.from_numpy((2000.0 * rng.random(
                    (b, n, n))).astype(np.float32)).to(dev)}
        for kind, dem in dems.items():
            per = dem.dim() == 3
            ref = march_plain(dem, pcol, fscal, k)
            got = march(dem, pcol, fscal, k)
            torch.cuda.synchronize()
            valid = ref > -1e30
            if got.shape != (b, w, k) or not torch.equal(got, ref):
                fail(f"batched march (B {b}, {kind}) != plain")
            if not valid.any():
                fail(f"batched march edge case (B {b}) has no valid sample")
            for v in range(b):
                one = march(dem[v] if per else dem, pcol[v], fscal[v], k)
                if not torch.equal(one, got[v]):
                    fail(f"batched march (B {b}, {kind}) viewpoint {v} != "
                         f"its unbatched launch")
            for s in (1, 2):
                shape = ((b,) if per else ()) + (s * n, s * n)
                colors = torch.from_numpy(rng.integers(
                    0, 1 << 24, shape, dtype=np.int32)).to(dev)
                ref_t, ref_c = march_plain(dem, pcol, fscal, k, colors, s)
                got_t, got_c = march_textured(dem, pcol, fscal, k, colors, s)
                torch.cuda.synchronize()
                if not (torch.equal(got_t, ref) and torch.equal(ref_t, ref)
                        and torch.equal(got_c, ref_c)):
                    fail(f"batched textured march (B {b}, {kind}, s {s}) != "
                         f"plain")
                if (got_c[~valid] != 0).any():
                    fail(f"batched textured march (B {b}) colors an invalid "
                         f"sample")
                for v in range(b):
                    one = march_textured(dem[v] if per else dem, pcol[v],
                                         fscal[v], k,
                                         colors[v] if per else colors, s)
                    if not (torch.equal(one[0], got_t[v])
                            and torch.equal(one[1], got_c[v])):
                        fail(f"batched textured march (B {b}, {kind}, s {s})"
                             f" viewpoint {v} != its unbatched launch")
            names.append(f"B {b} {kind} {float(valid.float().mean()):.2f} "
                         f"valid")
    log(f"[18] batched window march and textured march (cell and half-cell "
        f"planes, shared and per viewpoint) == batched plain bitwise and == "
        f"each viewpoint's unbatched launch at (W {w}, K {k}): "
        + "; ".join(names))
    # the 64-bit batch offsets: outputs past 2^31 elements
    b, w, k, n = BIG_BATCH
    p = params(b, n)
    pcol, fscal = pcol_fscal(crossing_geometry(p, width=w,
                                               cells_per_deg=CPD), p)
    dem = torch.from_numpy((2000.0 * rng.random((n, n))).astype(
        np.float32)).to(dev)
    colors = torch.from_numpy(rng.integers(0, 1 << 24, (2 * n, 2 * n),
                                           dtype=np.int32)).to(dev)
    check = sorted({0, b // 2, b - 3, b - 2, b - 1})
    got = march(dem, pcol, fscal, k)
    for v in check:
        if not torch.equal(got[v], march(dem, pcol[v], fscal[v], k)):
            fail(f"march at B {b} (outputs past 2^31): viewpoint {v} != "
                 f"its unbatched launch")
    del got
    got_t, got_c = march_textured(dem, pcol, fscal, k, colors, 2)
    for v in check:
        one = march_textured(dem, pcol[v], fscal[v], k, colors, 2)
        if not (torch.equal(got_t[v], one[0]) and torch.equal(got_c[v],
                                                              one[1])):
            fail(f"textured march at B {b}: viewpoint {v} != its unbatched "
                 f"launch")
    del got_t, got_c
    torch.cuda.synchronize()
    log(f"[18] batch of {b} at (W {w}, K {k}) = {b * w * k} samples (2^31 = "
        f"{1 << 31}): viewpoints {list(check)} == their unbatched launches, "
        f"both entries")


def reached_cells(n, vi, vj, d_lo, d_hi, cell_n, lat, az0=None, az1=None):
    """How many cells of an (n, n) grid a batch's marches of the band
    [d_lo, d_hi] reach, each cell counted once however many viewpoints
    reach it: the union over the viewpoints (sequences vi, vj; az0, az1 in
    radians, or the full circle) of the cells at a distance in [d_lo - one
    cell diagonal, d_hi] whose bearing lies in the viewpoint's window.
    Counted on the card."""
    cell_e = cell_n * math.cos(math.radians(lat))
    x = torch.arange(n, device=DEV, dtype=torch.float64)
    seen = torch.zeros((n, n), dtype=torch.bool, device=DEV)
    lo = max(0.0, d_lo - math.hypot(cell_n, cell_e))
    for b in range(len(vi)):
        de = ((x - vi[b]) * cell_e)[None, :]
        dn = ((x - vj[b]) * cell_n)[:, None]
        d2 = de * de + dn * dn
        m = (d2 <= d_hi * d_hi) & (d2 >= lo * lo)
        if az0 is not None:
            span = (az1[b] - az0[b]) % (2 * math.pi) or 2 * math.pi
            rel = torch.remainder(torch.atan2(de, dn) - az0[b], 2 * math.pi)
            m &= rel <= span
        seen |= m
    return int(seen.sum())


def batch_render_checks(tag, render, singles, launches_want, counters,
                        est_mb, extra_check=None):
    """Drive one batch through ``render(plain)`` (returns (image, ranges,
    guard)) with every counter at 0 just before it: launches, guards, the
    visible share, the plain versions' batch and each viewpoint's single
    render (``singles``, callables), all bitwise; the peak device memory
    above what was held before within ``est_mb``, the chunk's estimate.
    Returns (image, ranges, launches, peak MB, visible share)."""
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    img, rng, guard = render(False)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    launches = {fn.__name__: fn.launches for fn in counters}
    if launches != launches_want:
        fail(f"{tag}: launches {launches}, want {launches_want}")
    if peak_mb > est_mb:
        fail(f"{tag}: peak device memory {peak_mb:.1f} MB above the chunk's "
             f"estimate {est_mb:.1f} MB")
    vis = float((rng > 0).float().mean())
    if (guard != 0).any() or not 0.05 < vis < 0.95:
        fail(f"{tag}: guards {guard.sum(0).tolist()}, visible {vis}")
    img_p, rng_p, _ = render(True)
    if not (torch.equal(img, img_p) and torch.equal(rng, rng_p)):
        fail(f"{tag}: batch != the plain versions' batch")
    del img_p, rng_p
    for v, one in enumerate(singles):
        img1, rng1 = one()
        if not (torch.equal(img[v], img1) and torch.equal(rng[v], rng1)):
            fail(f"{tag}: viewpoint {v} != its single render")
    if extra_check is not None:
        extra_check(img, rng)
    return img, rng, launches, peak_mb, vis


def busy_text(busy):
    return "not measured" if busy is None else f"{100 * busy:.1f}%"


def batch_record(cell, batch, launches, ms, plain_ms, nbytes, ops, rate,
                 per_frame, loop, busy, peak_mb, chunks):
    b_ms, b_by = bound(nbytes, ops, rate)
    return dict(cell=cell, batch=batch, launches=launches, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                ms_per_frame=per_frame, ms_per_frame_single_loop=loop,
                device_busy=busy, peak_mb=peak_mb, chunks=chunks)


def batch_window_phases(dev, card, int32_rate, profile_dir=None):
    """Phases 19 and 20: suite configs 4 and 8 (benchmarks/suite.py:145,
    :288), a 60-frame camera path through render_path on the bench scene,
    untextured and with seeded half-cell colours. Returns {kernel name:
    batch record}."""
    from horizonator_tpu_torch.kernels.resolve import (resolve,
                                                       resolve_plain,
                                                       resolve_textured)
    from horizonator_tpu_torch.kernels.window_march import (march,
                                                            march_plain,
                                                            march_textured)
    from horizonator_tpu_torch.parallel import render_path, sharding
    from horizonator_tpu_torch.render import RenderParams, render_panorama
    from horizonator_tpu_torch.render.crossing import (N_NEAR,
                                                       crossing_geometry,
                                                       k_cross_for)
    from horizonator_tpu_torch.render.raymarch import horizon_rows
    from horizonator_tpu_torch.render.resolve_window import alpha_quantum
    from horizonator_tpu_torch.render.texture import prepare_color_planes
    from horizonator_tpu_torch.render.window import (march_from_geometry,
                                                     step_budget)
    n, fr, w, h = N, PATH_FRAMES, PATH_W, PATH_H
    dem = torch.from_numpy(bench_dem(n=n)).to(dev)
    k = k_cross_for(ZFAR, CPD, PATH_LAT, n=n)
    f = np.arange(fr)
    vi, vj = n / 2 + 3.0 * f, n / 2 + 2.0 * f        # 1700 + 3i, 1700 + 2i
    a0, a1 = -60.0 + 0.5 * f, 60.0 + 0.5 * f
    p = batch_params(dev, vi, vj, 900.0, PATH_LAT, a0, a1, 100.0, ZFAR)
    singles = [RenderParams(*(x[v] for x in p)) for v in range(fr)]
    rkw = dict(width=w, height=h, nsteps=k, cells_per_deg=CPD,
               sampler="window", lat_hint_deg=PATH_LAT)
    geo = crossing_geometry(p, width=w, cells_per_deg=CPD)
    pcol, fscal = pcol_fscal(geo, p)
    cell_n = 6371000.0 * math.pi / 180.0 / CPD
    cells = reached_cells(n, vi, vj, 0.0, ZFAR, cell_n, PATH_LAT,
                          np.radians(a0), np.radians(a1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cp = prepare_color_planes(torch.randint(
        0, 255, (3, 2 * n, 2 * n), generator=gen, device=dev,
        dtype=torch.uint8).float())
    out, untextured_rng = {}, None
    for tag, phase, extra in (("config 4", 19, {}),
                              ("config 8", 20, dict(textured=True,
                                                    color_planes=cp))):
        t0 = time.perf_counter()
        tex = bool(extra)
        mk, rs = (march_textured, resolve_textured) if tex else (march,
                                                                  resolve)
        k_tot = N_NEAR + step_budget(k, n)
        chunks = -(-fr // sharding.chunk_size(fr, w, h, k_tot, tex))
        est_mb = sharding.chunk_bytes(min(fr, sharding.chunk_size(
            fr, w, h, k_tot, tex)), w, h, k_tot, tex) / 1e6

        def render(plain, extra=extra):
            return render_path(dem, p, with_dropped=True, plain=plain,
                               **rkw, **extra)

        def same_ranges(img, rng):
            if untextured_rng is not None and not torch.equal(
                    rng, untextured_rng):
                fail(f"{tag}: textured ranges != config 4's")
        img, rng, launches, peak_mb, vis = batch_render_checks(
            tag, render, [lambda v=v: render_panorama(dem, singles[v], **rkw,
                                                       **extra)
                          for v in range(fr)],
            {mk.__name__: chunks, rs.__name__: chunks}, (mk, rs), est_mb,
            same_ranges)
        if not tex:
            untextured_rng = rng
        ms_batch = cuda_ms(lambda i: render_path(dem, p, **rkw, **extra),
                           5) / fr
        ms_loop = cuda_ms(lambda i: [render_panorama(dem, q, **rkw, **extra)
                                     for q in singles], SINGLE_LOOPS,
                          warmup=0) / fr     # warm from the checks
        # the batched launches alone, on the device clock
        march_out = march_from_geometry(
            dem, p, geo, k_cross=k, cells_per_deg=CPD,
            lat_hint_deg=PATH_LAT, color_planes=cp if tex else None)
        k_lim = march_out[0].shape[-1] - N_NEAR
        if tex:
            plane = cp.full_packed

            def m_call(plain=False):
                return (march_plain if plain else march_textured)(
                    dem, pcol, fscal, k_lim, plane, 2)
            same = all(torch.equal(a, b) for a, b in zip(m_call(),
                                                         m_call(True)))
        else:
            def m_call(plain=False):
                return (march_plain if plain else march)(dem, pcol, fscal,
                                                         k_lim)
            same = torch.equal(m_call(), m_call(True))
        if not same:
            fail(f"{tag}: batched march launch != plain")
        m_ms = graph_ms(m_call, BATCH_GRAPH_LAUNCHES)
        m_plain = cuda_ms_run(lambda i: m_call(True), 2, warmup=0)
        lanes = fr * w * k_lim
        m_bytes = (4 * cells * (5 if tex else 1) + pcol.nbytes + fscal.nbytes
                   + (8 if tex else 4) * lanes)
        m_ops = (MARCH_TEX_FLOPS if tex else MARCH_FLOPS) * lanes
        y = horizon_rows(march_out[0], p, width=w, height=h).reshape(
            -1, k_tot).contiguous()
        amax, int_first = alpha_quantum(k_tot, h)
        if tex:
            tx = march_out[2].reshape(-1, k_tot).contiguous()

            def r_call():
                return resolve_textured(y, tx, h, amax, int_first)

            def r_plain(i):
                return resolve_plain(y, h, amax, int_first, tex=tx)
        else:
            def r_call():
                return resolve(y, h, amax, int_first)

            def r_plain(i):
                return resolve_plain(y, h, amax, int_first)
        if not all(torch.equal(a, b) for a, b in zip(r_call(), r_plain(0))):
            fail(f"{tag}: batched resolve {tuple(y.shape)} != plain")
        del march_out
        r_ms = graph_ms(r_call, BATCH_GRAPH_LAUNCHES)
        r_plain_ms = cuda_ms_run(r_plain, 2, warmup=0)
        r_bytes = y.nbytes + (13 if tex else 9) * fr * w * h + (
            y.nbytes if tex else 0)
        r_ops = fr * w * (4 * k_tot + 12 * h) + (fr * w * h if tex else 0)
        busy = None
        if profile_dir:
            pout = os.path.join(profile_dir, f"profile_{tag.replace(' ', '')}"
                                f".txt")
            b_ms, _ = profile_renders(
                lambda i: render_path(dem, p, **rkw, **extra), 2, card, pout,
                f"2 batches of {fr} frames {w}x{h} ({tag})",
                (f"window_march_kernel<{'true' if tex else 'false'}",
                 f"resolve_kernel<{'true' if tex else 'false'}"))
            busy = b_ms / (ms_batch * fr)
        mb = batch_record(tag, fr, launches[mk.__name__], m_ms, m_plain,
                          m_bytes, m_ops, FP32_OPS_PER_S, ms_batch, ms_loop,
                          busy, peak_mb, chunks)
        rb = batch_record(tag, fr, launches[rs.__name__], r_ms, r_plain_ms,
                          r_bytes, r_ops, int32_rate, ms_batch, ms_loop, busy,
                          peak_mb, chunks)
        out[mk.__name__.replace("march", "window_march")] = mb
        out[rs.__name__] = rb
        log(f"[{phase}] {tag}: render_path of {fr} frames {w}x{h} (K "
            f"{k_tot}), chunks {chunks}, launches {launches}: == plain "
            f"versions' batch and == {fr} single renders bitwise, guards 0, "
            f"visible {vis:.4f}" + (", ranges == config 4's" if tex else ""))
        log(f"[{phase}] {tag}: ms per frame batched {ms_batch:.4f} (median "
            f"of 5 batches), single-render loop {ms_loop:.4f} (median of "
            f"{SINGLE_LOOPS} loops of {fr}), {ms_loop / ms_batch:.2f}x; "
            f"device busy {busy_text(busy)}; peak device memory "
            f"{peak_mb:.1f} MB (estimate {est_mb:.1f} MB, budget "
            f"{sharding.BATCH_BYTES / 1e6:.0f} MB)")
        log(f"[{phase}] {tag}: batched march ({fr}, {w}, {k_lim}) device ms "
            f"{m_ms:.4f}, bound {mb['bound_ms']:.5f} ({mb['bound_by']}: "
            f"{cells} DEM cells, the union the batch reaches, read once"
            f"{' with 4 texels each' if tex else ''}), share "
            f"{100 * mb['bound_ms'] / m_ms:.1f}% (plain {m_plain:.3f}); "
            f"batched resolve {tuple(y.shape)} -> H {h} device ms "
            f"{r_ms:.4f}, bound {rb['bound_ms']:.5f} ({rb['bound_by']}), "
            f"share {100 * rb['bound_ms'] / r_ms:.1f}% (plain "
            f"{r_plain_ms:.3f})")
        log(f"[t] phase {phase}: {time.perf_counter() - t0:.1f} s")
        del img, rng, y
    del cp, dem
    return out


def batch_lod_phase(dev, card, int32_rate, profile_dir=None):
    """Phase 21: suite configs 3 and 9 (benchmarks/suite.py:122, :323),
    64-viewpoint LOD batches through render_path(sampler="lod"),
    untextured and with seeded cell colours. Returns {kernel name: batch
    record}."""
    from horizonator_tpu_torch.kernels.resolve import (resolve,
                                                       resolve_plain,
                                                       resolve_textured)
    from horizonator_tpu_torch.kernels.window_march import (march,
                                                            march_plain,
                                                            march_textured)
    from horizonator_tpu_torch.parallel import render_path, sharding
    from horizonator_tpu_torch.render import (RenderParams, lod,
                                              render_panorama)
    from horizonator_tpu_torch.render.raymarch import horizon_rows
    from horizonator_tpu_torch.render.resolve_window import alpha_quantum
    from horizonator_tpu_torch.render.texture import ColorPlanes2x
    from horizonator_tpu_torch.render.window import step_budget
    t0 = time.perf_counter()
    n, bsz, w, h = LOD_N, LOD_BATCH, LOD_W, LOD_H
    dem = torch.from_numpy(bench_dem(seed=7, n=n)).to(dev)
    plan = lod.lod_plan(LOD_ZFAR, w, LOD_CPD, LOD_LAT, n)
    nlev = 1 + max(s.level for s in plan)
    pyr = lod.build_pyramid(dem, nlev)
    i = np.arange(bsz)
    p = batch_params(dev, n / 2 + 13.0 * i, n / 2, LOD_VZ, LOD_LAT,
                     np.full(bsz, -180.0), np.full(bsz, 180.0), 100.0,
                     LOD_ZFAR)
    singles = [RenderParams(*(x[v] for x in p)) for v in range(bsz)]
    rkw = dict(width=w, height=h, nsteps=1, cells_per_deg=LOD_CPD,
               lat_hint_deg=LOD_LAT, sampler="lod", lod_plan=plan)
    lkw = dict(width=w, cells_per_deg=LOD_CPD, lat_hint_deg=LOD_LAT)
    k_tot = 4 + sum(s.k_len for s in plan)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cpyr = lod.build_color_pyramid(torch.randint(
        0, 255, (3, n, n), generator=gen, device=dev,
        dtype=torch.uint8).float(), nlev, n)
    out, untextured_rng = {}, None
    for tag, cp in (("config 3", None), ("config 9", cpyr)):
        tex = cp is not None
        extra = dict(textured=True, color_planes=cp) if tex else {}
        mk, rs = (march_textured, resolve_textured) if tex else (march,
                                                                  resolve)
        step = sharding.chunk_size(bsz, w, h, k_tot, tex)
        chunks = -(-bsz // step)
        est_mb = sharding.chunk_bytes(min(bsz, step), w, h, k_tot, tex) / 1e6

        def render(plain, extra=extra):
            return render_path(pyr, p, with_dropped=True, plain=plain,
                               **rkw, **extra)

        def same_ranges(img, rng):
            if untextured_rng is not None and not torch.equal(
                    rng, untextured_rng):
                fail(f"{tag}: textured ranges != config 3's")
        img, rng, launches, peak_mb, vis = batch_render_checks(
            tag, render, [lambda v=v: render_panorama(pyr, singles[v], **rkw,
                                                       **extra)
                          for v in range(bsz)],
            {mk.__name__: nlev * chunks, rs.__name__: chunks}, (mk, rs),
            est_mb, same_ranges)
        if not tex:
            untextured_rng = rng
        if float(rng.max()) < plan[2].d_lo:
            fail(f"{tag}: nothing seen past level 1's band")
        ms_batch = cuda_ms(lambda i: render_path(pyr, p, **rkw, **extra),
                           3, warmup=1) / bsz
        ms_loop = cuda_ms(lambda i: [render_panorama(pyr, q, **rkw, **extra)
                                     for q in singles], SINGLE_LOOPS,
                          warmup=0) / bsz    # warm from the checks
        # each level's batched march launch and the resolve, alone
        levels = []
        for spec in plan:
            dem_c, p_c, colors_c, geo = lod.level_inputs(
                pyr, p, spec, color_pyramid=cp, **lkw)
            pcol, fscal = pcol_fscal(geo, p_c)
            k_lim = step_budget(spec.k_lo + spec.k_len, dem_c.shape[-1])
            if tex:
                plane, s = ((colors_c.full_packed, 2)
                            if isinstance(colors_c, ColorPlanes2x)
                            else (colors_c, 1))

                def m_call(plain=False, d=dem_c, pc=pcol, fs=fscal, kk=k_lim,
                           pl=plane, ss=s):
                    return (march_plain if plain else march_textured)(
                        d, pc, fs, kk, pl, ss)
                same = all(torch.equal(a, b) for a, b in zip(m_call(),
                                                             m_call(True)))
            else:
                s = 1

                def m_call(plain=False, d=dem_c, pc=pcol, fs=fscal,
                           kk=k_lim):
                    return (march_plain if plain else march)(d, pc, fs, kk)
                same = torch.equal(m_call(), m_call(True))
            if not same:
                fail(f"{tag}: level {spec.level} batched march (crops "
                     f"{tuple(dem_c.shape)}, K {k_lim}) != plain")
            ms = graph_ms(m_call, BATCH_GRAPH_LAUNCHES)
            plain_ms = cuda_ms_run(lambda i: m_call(True), 2, warmup=0)
            p_l = lod._scaled_params(p, spec.level)
            cells = reached_cells(
                pyr[spec.level].shape[0], p_l.viewer_cell_i.tolist(),
                p_l.viewer_cell_j.tolist(), spec.d_lo, spec.d_hi,
                6371000.0 * math.pi / 180.0 / (LOD_CPD / 2 ** spec.level),
                LOD_LAT)
            lanes = bsz * w * k_lim
            nbytes = 4 * cells * ((1 + s * s) if tex else 1) + (
                8 if tex else 4) * lanes
            b_ms, b_by = bound(nbytes, (MARCH_TEX_FLOPS if tex
                                        else MARCH_FLOPS) * lanes,
                               FP32_OPS_PER_S)
            levels.append(dict(level=spec.level, crops=tuple(dem_c.shape),
                               k=k_lim, ms=ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by, cells=cells))
        mo = lod.march_lod(pyr, p, plan=plan, color_pyramid=cp, **lkw)
        y = horizon_rows(mo[0], p, width=w, height=h).reshape(
            -1, k_tot).contiguous()
        amax, int_first = alpha_quantum(k_tot, h)
        if tex:
            tx = mo[3].reshape(-1, k_tot).contiguous()

            def r_call():
                return resolve_textured(y, tx, h, amax, int_first)

            def r_plain(i):
                return resolve_plain(y, h, amax, int_first, tex=tx)
        else:
            def r_call():
                return resolve(y, h, amax, int_first)

            def r_plain(i):
                return resolve_plain(y, h, amax, int_first)
        if not all(torch.equal(a, b) for a, b in zip(r_call(), r_plain(0))):
            fail(f"{tag}: batched resolve {tuple(y.shape)} != plain")
        del mo
        r_ms = graph_ms(r_call, BATCH_GRAPH_LAUNCHES)
        r_plain_ms = cuda_ms_run(r_plain, 2, warmup=0)
        r_bytes = y.nbytes * (2 if tex else 1) + (13 if tex else 9) * (
            bsz * w * h)
        r_ops = bsz * w * (4 * k_tot + 12 * h) + (bsz * w * h if tex else 0)
        busy = None
        if profile_dir:
            pout = os.path.join(profile_dir, f"profile_{tag.replace(' ', '')}"
                                f".txt")
            b_busy, _ = profile_renders(
                lambda i: render_path(pyr, p, **rkw, **extra), 2, card, pout,
                f"2 batches of {bsz} LOD viewpoints {w}x{h} ({tag})",
                (f"window_march_kernel<{'true' if tex else 'false'}",
                 f"resolve_kernel<{'true' if tex else 'false'}"))
            busy = b_busy / (ms_batch * bsz)
        mb = batch_record(tag, bsz, launches[mk.__name__],
                          sum(lv["ms"] for lv in levels),
                          sum(lv["plain_ms"] for lv in levels), 0, 0,
                          FP32_OPS_PER_S, ms_batch, ms_loop, busy, peak_mb,
                          chunks)
        mb.update(bound_ms=sum(lv["bound_ms"] for lv in levels),
                  bound_by="per level", levels=levels)
        rb = batch_record(tag, bsz, launches[rs.__name__], r_ms, r_plain_ms,
                          r_bytes, r_ops, int32_rate, ms_batch, ms_loop, busy,
                          peak_mb, chunks)
        out[mk.__name__.replace("march", "window_march")] = mb
        out[rs.__name__] = rb
        log(f"[21] {tag}: render_path of {bsz} LOD viewpoints {w}x{h} ({nlev}"
            f" levels, K {k_tot}), chunks {chunks}, launches {launches}: == "
            f"plain versions' batch and == {bsz} single renders bitwise, "
            f"guards 0, visible {vis:.4f}, max range {float(rng.max()):.0f} m"
            + (", ranges == config 3's" if tex else ""))
        log(f"[21] {tag}: ms per viewpoint batched {ms_batch:.4f} (median of "
            f"3 batches), single-render loop {ms_loop:.4f} (median of "
            f"{SINGLE_LOOPS} loops of {bsz}), {ms_loop / ms_batch:.2f}x; "
            f"device busy {busy_text(busy)}; peak device memory "
            f"{peak_mb:.1f} MB (estimate {est_mb:.1f} MB, budget "
            f"{sharding.BATCH_BYTES / 1e6:.0f} MB)")
        for lv in levels:
            log(f"[21] {tag}: level {lv['level']} batched march (crops "
                f"{lv['crops']}, K {lv['k']}) device ms {lv['ms']:.4f}, bound "
                f"{lv['bound_ms']:.5f} ({lv['bound_by']}: {lv['cells']} "
                f"cells, the union of the batch's annuli, read once), share "
                f"{100 * lv['bound_ms'] / lv['ms']:.1f}% (plain "
                f"{lv['plain_ms']:.3f})")
        log(f"[21] {tag}: batched resolve {tuple(y.shape)} -> H {h} device ms "
            f"{r_ms:.4f}, bound {rb['bound_ms']:.5f} ({rb['bound_by']}), "
            f"share {100 * rb['bound_ms'] / r_ms:.1f}% (plain "
            f"{r_plain_ms:.3f})")
        del img, rng, y
    del cpyr, pyr, dem
    log(f"[t] phase 21: {time.perf_counter() - t0:.1f} s")
    return out


def api_paging_phase(dev):
    """Phase 22: the API's render_batch on phase 6's tiles (window) and on
    phase 17's SRTM1 tile (auto-LOD), each viewpoint bitwise its own
    render(); fly over a seeded 6000^2 host grid in a 2048 window (margin
    256), its frames bitwise renders on windows placed at the same
    origins."""
    from horizonator_tpu_torch import horizonator
    from horizonator_tpu_torch.dem.paging import PagedWindow, fly
    from horizonator_tpu_torch.kernels.resolve import resolve
    from horizonator_tpu_torch.kernels.window_march import march
    from horizonator_tpu_torch.render import make_params, render_panorama
    from horizonator_tpu_torch.render.crossing import k_cross_for
    t0 = time.perf_counter()
    for name, writer, lat, lon, kw in (
            ("3x3 SRTM3 tiles", lambda d: write_tiles(d, 34, -118), 34.4,
             -117.6, {}),
            ("an SRTM1 tile (LOD)", write_srtm1_tile, 34.5, -117.5,
             dict(SRTM1=True))):
        with tempfile.TemporaryDirectory() as td:
            writer(td)
            h = horizonator(lat, lon, W, H, dir_dems=td, device=dev, **kw)
            lats = [lat, lat + 0.02, lat - 0.015, lat + 0.03]
            lons = [lon, lon + 0.02, lon - 0.03, lon + 0.035]
            march.launches = resolve.launches = 0
            t1 = time.perf_counter()
            imgs, rngs = h.render_batch(-180, 180, lats, lons)
            batch_s = time.perf_counter() - t1
            launches = {"march": march.launches, "resolve": resolve.launches}
            _, sampler, _, plan, _ = h._batch_render_plan(100.0, 40000.0)
            want = {"march": len(plan) if plan else 1, "resolve": 1}
            if launches != want or imgs.shape != (4, H, W, 3):
                fail(f"API render_batch on {name}: launches {launches}, want "
                     f"{want}; {imgs.shape}")
            t1 = time.perf_counter()
            for b in range(4):
                img1, rng1 = h.render(-180, 180, lat=lats[b], lon=lons[b])
                if not (np.array_equal(imgs[b], img1)
                        and np.array_equal(rngs[b], rng1)):
                    fail(f"API render_batch on {name}: viewpoint {b} != its "
                         f"render()")
            single_s = time.perf_counter() - t1
            log(f"[22] API render_batch of 4 viewpoints {W}x{H} on {name} "
                f"({sampler}): launches {launches}, each viewpoint == its "
                f"render() bitwise; {1e3 * batch_s / 4:.2f} ms a viewpoint "
                f"batched, {1e3 * single_s / 4:.2f} ms a render() (host "
                f"clock, host copies included, first batch)")
    # paging: a fly-through over a host grid three windows wide
    n, wc, margin = FLY_N, FLY_WINDOW, FLY_MARGIN
    chunk, fr = FLY_CHUNK, FLY_FRAMES
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    x = torch.arange(n, device=dev, dtype=torch.float32)
    host = torch.clamp(
        600.0 + 500.0 * torch.sin(x / 223.0)[None, :]
        * torch.cos(x / 181.0)[:, None]
        + 30.0 * torch.randn((n, n), generator=gen, device=dev),
        min=0.0).cpu().numpy()
    path = np.stack([np.linspace(0.18 * n, 0.82 * n, fr),
                     np.linspace(0.25 * n, 0.67 * n, fr)], axis=1)
    fkw = dict(width=PATH_W, height=PATH_H, zfar_m=ZFAR, cells_per_deg=CPD,
               lat_deg=PATH_LAT)
    march.launches = 0
    t1 = time.perf_counter()
    imgs, rngs, uploads = fly(host, path, window_cells=wc,
                              margin_cells=margin, chunk=chunk, device=dev,
                              **fkw)
    fly_s = time.perf_counter() - t1
    fly_launches = march.launches
    if uploads < 2 or fly_launches != fr // chunk:
        fail(f"fly: {uploads} uploads, {fly_launches} march launches")
    win = PagedWindow(host, wc, margin, device=dev)
    k = k_cross_for(ZFAR, CPD, PATH_LAT, n=wc)
    for s in range(0, fr, chunk):
        win.ensure(*path[s + chunk // 2])
        for f in range(s, s + chunk):
            li, lj = win.local_cell(*path[f])
            j0, i0 = (int(math.floor(v)) + o for v, o in zip((lj, li),
                                                             win.origin))
            p = make_params(
                device=dev, viewer_cell_i=li, viewer_cell_j=lj,
                viewer_z=float(host[j0:j0 + 2, i0:i0 + 2].max()) + 50.0,
                cos_viewer_lat=math.cos(math.radians(PATH_LAT)),
                az_rad0=math.radians(-60.0), az_rad1=math.radians(60.0),
                znear=100.0, zfar=ZFAR, znear_color=100.0, zfar_color=ZFAR)
            img, rng = render_panorama(win.dem, p, width=PATH_W,
                                       height=PATH_H, nsteps=k,
                                       cells_per_deg=CPD,
                                       lat_hint_deg=PATH_LAT)
            if not (np.array_equal(imgs[f], img.cpu().numpy())
                    and np.array_equal(rngs[f], rng.cpu().numpy())):
                fail(f"fly frame {f} != its render on the window at "
                     f"{win.origin}")
    if win.uploads != uploads:
        fail(f"fly uploads {uploads} != the replayed window's {win.uploads}")
    log(f"[22] fly over a {n}^2 host grid, window {wc} (margin {margin}), "
        f"{fr} frames {PATH_W}x{PATH_H} in segments of {chunk}: {uploads} "
        f"uploads, {fly_launches} march launches, every frame == its "
        f"render on a window at the same origin bitwise; "
        f"{1e3 * fly_s / fr:.2f} ms a frame (host clock, uploads and host "
        f"copies included)")
    log(f"[t] phase 22: {time.perf_counter() - t0:.1f} s")


def march_launch_record(cell, dem, p, width, k, n, lat, launches, per_vp,
                        loop, busy, peak_mb, chunks):
    """The batched march launch of a viewshed cell alone: bitwise against
    its plain version, its device ms (graph replay) and plain ms, and its
    record against a bound that counts the DEM cells the batch reaches
    (the union, read once, as reached_cells), (B, W, 8) + (B, 4) params in
    and (B, W, K) samples out."""
    from horizonator_tpu_torch.kernels.window_march import march, march_plain
    from horizonator_tpu_torch.render.crossing import crossing_geometry
    from horizonator_tpu_torch.render.window import step_budget
    geo = crossing_geometry(p, width=width, cells_per_deg=CPD)
    pcol, fscal = pcol_fscal(geo, p)
    k_lim = step_budget(k, n)
    got, ref = march(dem, pcol, fscal, k_lim), march_plain(dem, pcol, fscal,
                                                           k_lim)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        fail(f"{cell}: batched march {tuple(got.shape)} != plain: "
             f"{int((got != ref).sum())} samples differ")
    del got, ref
    m_ms = graph_ms(lambda: march(dem, pcol, fscal, k_lim),
                    BATCH_GRAPH_LAUNCHES)
    m_plain = cuda_ms_run(lambda i: march_plain(dem, pcol, fscal, k_lim), 2,
                          warmup=0)
    vi, vj = (x.cpu().numpy().reshape(-1) for x in (p.viewer_cell_i,
                                                     p.viewer_cell_j))
    cell_n = 6371000.0 * math.pi / 180.0 / CPD
    cells = reached_cells(n, vi, vj, 0.0, float(p.zfar.reshape(-1)[0]),
                          cell_n, lat)
    b = vi.shape[0]
    lanes = b * width * k_lim
    rec = batch_record(cell, b, launches, m_ms, m_plain,
                       4 * cells + pcol.nbytes + fscal.nbytes + 4 * lanes,
                       MARCH_FLOPS * lanes, FP32_OPS_PER_S, per_vp, loop,
                       busy, peak_mb, chunks)
    log(f"[{cell}] batched march ({b}, {width}, {k_lim}) == plain bitwise; "
        f"device ms {m_ms:.4f}, bound {rec['bound_ms']:.5f} "
        f"({rec['bound_by']}: {cells} DEM cells, the union the batch "
        f"reaches, read once), share {100 * rec['bound_ms'] / m_ms:.1f}% "
        f"(plain {m_plain:.3f})")
    return rec


def peak_run(fn):
    """fn()'s result and the device memory it allocated at its peak above
    what was held before, MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e6


def profile_busy(fn, n, card, profile_dir, tag, title):
    """Device busy ms per call of fn over n calls under torch.profiler, and
    the march kernel's in-call ms; (None, None) without --profile."""
    if not profile_dir:
        return None, None
    path = os.path.join(profile_dir, f"profile_{tag}.txt")
    busy, in_frame = profile_renders(lambda i: fn(), n, card, path, title,
                                     ("window_march_kernel<false",))
    return busy, in_frame["window_march_kernel<false"]


def sweep_phase(dev, card, profile_dir=None):
    """Phase 23: suite config 5 (benchmarks/suite.py:171), horizon_sweep of
    1024 viewpoints on a 32 x 32 lattice over a 1200^2 grid. Returns the
    batched march's record."""
    from horizonator_tpu_torch.kernels.window_march import march
    from horizonator_tpu_torch.ops import horizon_sweep
    from horizonator_tpu_torch.parallel import sharding
    from horizonator_tpu_torch.render import RenderParams
    from horizonator_tpu_torch.render.crossing import N_NEAR, k_cross_for
    from horizonator_tpu_torch.render.window import step_budget
    t0 = time.perf_counter()
    n, w, b = VS_N, SWEEP_W, SWEEP_GRID ** 2
    dem = torch.from_numpy(bench_dem(n=n)).to(dev)
    k = k_cross_for(VS_ZFAR, CPD, LAT, n=n)
    ii, jj = np.meshgrid(np.linspace(100, n - 100, SWEEP_GRID),
                         np.linspace(100, n - 100, SWEEP_GRID))
    p = batch_params(dev, ii.ravel(), jj.ravel(), 700.0, LAT, -180.0, 180.0,
                     50.0, VS_ZFAR)
    kw = dict(width=w, nsteps=k, cells_per_deg=CPD, sampler="window",
              lat_hint_deg=LAT)
    chunks = -(-b // sharding.chunk_size(b, w, 0,
                                         N_NEAR + step_budget(k, n)))
    march.launches = 0
    hz, peak_mb = peak_run(lambda: horizon_sweep(dem, p, **kw))
    launches = march.launches
    if launches != chunks or hz.shape != (b, w):
        fail(f"config 5: launches {launches} (chunks {chunks}), "
             f"{tuple(hz.shape)}")
    valid = hz > -1e30
    if not valid.all() or not torch.isfinite(hz).all():
        fail(f"config 5: {int((~valid).sum())} columns without a horizon")
    if not torch.equal(hz, horizon_sweep(dem, p, plain=True, **kw)):
        fail("config 5: sweep != the plain versions' sweep")
    singles = [RenderParams(*(x[v:v + 1] for x in p)) for v in range(b)]
    torch.cuda.synchronize()
    t1 = torch.cuda.Event(enable_timing=True)
    t2 = torch.cuda.Event(enable_timing=True)
    t1.record()
    ones = [horizon_sweep(dem, q, **kw) for q in singles]
    t2.record()
    t2.synchronize()
    loop = t1.elapsed_time(t2) / b
    for v, one in enumerate(ones):
        if not torch.equal(one[0], hz[v]):
            fail(f"config 5: viewpoint {v} != its single sweep")
    del ones
    per_vp = cuda_ms(lambda i: horizon_sweep(dem, p, **kw), 5) / b
    busy, in_call = profile_busy(lambda: horizon_sweep(dem, p, **kw), 3,
                                 card, profile_dir, "config5",
                                 f"3 sweeps of {b} viewpoints")
    busy_share = None if busy is None else busy / (per_vp * b)
    log(f"[23] config 5: horizon_sweep of {b} viewpoints (W {w}, K "
        f"{N_NEAR + step_budget(k, n)}) over {n}^2: {launches} march "
        f"launch(es), chunks {chunks}, == plain versions' sweep and == "
        f"{b} single sweeps bitwise; tan el {float(hz.min()):.4f}.."
        f"{float(hz.max()):.4f}")
    log(f"[23] config 5: us per viewpoint batched {1e3 * per_vp:.3f} (median "
        f"of 5 sweeps), single sweeps {1e3 * loop:.3f} ({loop / per_vp:.1f}x)"
        f"; device busy {busy_text(busy_share)}"
        + (f", march in the sweep {in_call:.4f} ms" if in_call else "")
        + f"; peak device memory {peak_mb:.1f} MB")
    rec = march_launch_record("config 5", dem, p, w, k, n, LAT, launches,
                              per_vp, loop, busy_share, peak_mb, chunks)
    log(f"[t] phase 23: {time.perf_counter() - t0:.1f} s")
    return rec


def read_tiff(path):
    """(tags {id: values}, pixel bytes) of a single-IFD little-endian TIFF
    as geotiff.write_geotiff writes it."""
    import struct
    with open(path, "rb") as f:
        buf = f.read()
    order, magic, ifd = struct.unpack_from("<2sHI", buf, 0)
    if order != b"II" or magic != 42:
        fail(f"{path}: not a little-endian TIFF")
    (count,) = struct.unpack_from("<H", buf, ifd)
    sizes = {2: 1, 3: 2, 4: 4, 12: 8}
    pats = {2: "s", 3: "H", 4: "I", 12: "d"}
    tags = {}
    for e in range(count):
        tag, typ, cnt = struct.unpack_from("<HHI", buf, ifd + 2 + 12 * e)
        off = ifd + 10 + 12 * e
        if sizes[typ] * cnt > 4:
            (off,) = struct.unpack_from("<I", buf, off)
        tags[tag] = (struct.unpack_from(f"<{cnt}s", buf, off) if typ == 2
                     else struct.unpack_from(f"<{cnt}{pats[typ]}", buf, off))
    return tags, buf[tags[273][0]:tags[273][0] + tags[279][0]]


def cli_viewshed_check(dev, sampler="window"):
    """The CLI's --viewshed on phase 6's tiles (a full circle at the default
    zfar) with --viewshed-sampler ``sampler``, its TIFF read back: size,
    format, pixel scale and tiepoint of the raster around the viewer,
    pixels bitwise viewshed_grid's, north up."""
    from horizonator_tpu_torch import cli, geometry
    from horizonator_tpu_torch.dem import load_mosaic
    from horizonator_tpu_torch.kernels.window_march import march
    from horizonator_tpu_torch.ops import viewshed_grid
    from horizonator_tpu_torch.render import make_params
    from horizonator_tpu_torch.render.crossing import k_cross_for
    lat, lon, zfar = 34.4, -117.6, 40000.0
    with tempfile.TemporaryDirectory() as td:
        write_tiles(td, 34, -118)
        out = os.path.join(td, "viewshed.tif")
        march.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--dirdems", td, "--viewshed", out,
                       "--viewshed-sampler", sampler, str(lat), str(lon),
                       "0", "180"])
        cli_s = time.perf_counter() - t0
        if rc != 0 or march.launches != (sampler == "window"):
            fail(f"CLI --viewshed rc {rc}, march launches {march.launches}")
        tags, pix = read_tiff(out)
        m = load_mosaic(lat, lon, render_radius_m=zfar, datadir=td)
    n, cpd = m.grid.shape[0], m.cells_per_deg
    ci, cj = m.viewer_cell(lat, lon)
    cos_lat = math.cos(math.radians(lat))
    cell_n = geometry.EARTH_RADIUS_M * math.pi / 180.0 / cpd
    hw = max(8, min(int(math.ceil(zfar / (cell_n * cos_lat))),
                    int(min(ci, cj, n - 1 - ci, n - 1 - cj))))
    width = int(min(4096, max(256, -(-2.0 * math.pi * hw // 256) * 256)))
    p = make_params(device=dev, viewer_cell_i=ci, viewer_cell_j=cj,
                    viewer_z=m.auto_viewer_z(lat, lon),
                    cos_viewer_lat=cos_lat, az_rad0=math.radians(-180.0),
                    az_rad1=math.radians(180.0), znear=100.0, zfar=zfar,
                    znear_color=100.0, zfar_color=zfar)
    vis = viewshed_grid(
        torch.from_numpy(m.grid.astype(np.float32)).to(dev), p, width=width,
        nsteps=k_cross_for(zfar, cpd, lat, n=n), cells_per_deg=cpd,
        out_halfwidth=hw, sampler=sampler, lat_hint_deg=lat,
        znear_hint_m=100.0, full_circle=True).cpu().numpy()
    olon, olat = m.origin_dem_lon_lat
    oi, oj = m.origin_dem_cellij
    want = {256: (2 * hw,), 257: (2 * hw,), 258: (8,), 339: (1,),
            33550: (1.0 / cpd, 1.0 / cpd, 0.0),
            33922: (0.0, 0.0, 0.0, olon + (oi + ci - hw) / cpd,
                    olat + (oj + cj + hw) / cpd, 0.0)}
    for tag, v in want.items():
        if not np.allclose(tags[tag], v, rtol=0, atol=1e-9):
            fail(f"CLI --viewshed TIFF tag {tag} {tags[tag]}, want {v}")
    got = np.frombuffer(pix, np.uint8).reshape(2 * hw, 2 * hw)
    if not np.array_equal(got, vis[::-1].astype(np.uint8)):
        fail("CLI --viewshed TIFF pixels != viewshed_grid's raster")
    log(f"[{24 if sampler == 'window' else 30}] CLI --viewshed "
        f"--viewshed-sampler {sampler} on phase 6's tiles: {2 * hw}x{2 * hw} "
        f"cells, "
        f"W {width}, written and read back in {cli_s:.2f} s: tags (size, "
        f"uint8, pixel scale, NW tiepoint) as computed, pixels == "
        f"viewshed_grid's raster north up, visible {vis.mean():.4f}")


def raster_phase(dev, card, profile_dir=None):
    """Phase 24: suite config 7 (benchmarks/suite.py:257), one 800 x 800
    viewshed_grid raster at W 720 (full circle, the contract resampler),
    then the gather resampler, a partial window and a fixed frame; the
    CLI's --viewshed. Returns the march launch's record."""
    from horizonator_tpu_torch.kernels.window_march import march
    from horizonator_tpu_torch.ops import viewshed_grid
    from horizonator_tpu_torch.render import make_params
    from horizonator_tpu_torch.render.crossing import k_cross_for
    t0 = time.perf_counter()
    n, hw, w = VS_N, VS_HW, VS_W
    dem = torch.from_numpy(bench_dem(n=n)).to(dev)
    k = k_cross_for(VS_ZFAR, CPD, LAT, n=n)

    def params(az0=-180.0, az1=180.0):
        return make_params(device=dev, viewer_cell_i=n / 2,
                           viewer_cell_j=n / 2, viewer_z=900.0,
                           cos_viewer_lat=math.cos(math.radians(LAT)),
                           az_rad0=math.radians(az0),
                           az_rad1=math.radians(az1), znear=50.0,
                           zfar=VS_ZFAR, znear_color=50.0, zfar_color=VS_ZFAR)
    p = params()
    kw = dict(width=w, nsteps=k, cells_per_deg=CPD, out_halfwidth=hw,
              sampler="window", lat_hint_deg=LAT, with_dropped=True)
    cases = [("contract, full circle", p, dict(full_circle=True)),
             ("gather", p, dict(method="gather")),
             ("contract, window -30..140 deg", params(-30.0, 140.0), {}),
             ("contract, window -30..140 deg under full_circle",
              params(-30.0, 140.0), dict(full_circle=True)),
             (f"contract, fixed frame ({n / 2 - 40:g}, {n / 2 + 40:g}), full "
              f"circle", p, dict(full_circle=True, out_center_ij=(
                  n / 2 - 40.0, n / 2 + 40.0)))]
    rasters = {}
    for name, q, extra in cases:
        march.launches = 0
        (vis, guard), peak_mb = peak_run(lambda: viewshed_grid(
            dem, q, **kw, **extra))
        launches = march.launches
        vis_p, guard_p = viewshed_grid(dem, q, plain=True, **kw, **extra)
        if not (torch.equal(vis, vis_p) and int(guard) == int(guard_p)):
            fail(f"config 7 {name}: raster != the plain versions' (direct "
                 f"masked max): {int((vis != vis_p).sum())} cells, guards "
                 f"{int(guard)} / {int(guard_p)}")
        broken = name.endswith("under full_circle")
        share = float(vis.float().mean())
        if (vis.shape != (2 * hw, 2 * hw) or launches != 1
                or (int(guard) > 0) != broken or not 0.02 < share < 0.98):
            fail(f"config 7 {name}: {tuple(vis.shape)}, launches {launches}"
                 f", guard {int(guard)}, visible {share}")
        rasters[name] = vis
        log(f"[24] config 7 {name}: {2 * hw}x{2 * hw} raster, 1 march "
            f"launch, == the "
            f"plain versions' (direct masked max) bitwise, guard "
            f"{int(guard)}, visible {share:.4f}, peak device memory "
            f"{peak_mb:.1f} MB")
    full = rasters["contract, full circle"]
    log(f"[24] config 7: gather differs from contract in "
        f"{float((rasters['gather'] != full).float().mean()):.4%} of cells")
    kw.pop("with_dropped")
    ms = {m: cuda_ms(lambda i, m=m: viewshed_grid(
        dem, p, method=m, full_circle=True, **kw), 10)
        for m in ("contract", "gather")}
    ms_plain = cuda_ms(lambda i: viewshed_grid(
        dem, p, full_circle=True, plain=True, **kw), 3)
    busy, in_call = profile_busy(
        lambda: viewshed_grid(dem, p, full_circle=True, **kw), 5, card,
        profile_dir, "config7", "5 rasters 800x800")
    busy_share = None if busy is None else busy / ms["contract"]
    log(f"[24] config 7: ms per raster (median of 10) contract "
        f"{ms['contract']:.3f}, gather {ms['gather']:.3f}; plain versions "
        f"(direct masked max) {ms_plain:.3f}; device busy "
        f"{busy_text(busy_share)}"
        + (f", {busy:.3f} ms a raster of which the march {in_call:.4f}"
           if busy else ""))
    rec = march_launch_record("config 7", dem, p, w, k, n, LAT, 1,
                              ms["contract"], None, busy_share, peak_mb, 1)
    cli_viewshed_check(dev)
    log(f"[t] phase 24: {time.perf_counter() - t0:.1f} s")
    return rec


# float32 operations a cell and viewpoint of viewshed_cells_kernel, counted
# from viewshed_resample.cu with atan2f, the square root and each division
# as one: every cell-viewpoint takes its offsets, east and north, distance,
# grid position and the six range and grid tests (16); one in range, on the
# grid and in the azimuth window goes on through the azimuth and its column
# (22), the arc test, its radius and a binary search of 9 steps at K 324
# (14), the four taps' sum, the tangent and its compare (12): 48 more.
# Cells in range but outside the window do 12 more than the 16 they are
# counted at; one the arcs leave uncovered (none at config 10) skips the
# radius and search.
RESAMPLE_OPS_ALL, RESAMPLE_OPS_LIVE = 16, 48


def resample_record(dem, p, w, k, hw, center, call_launches):
    """The resampler's two launches on one batch's march (phase 25): the
    count bitwise resample_plain's, its launches counted around that call,
    the columns kernel and both kernels timed by graph replay, the plain
    version's ms, and the bound of what the function must move and do:
    the march's tangents and distances read, the DEM, the count read and
    written; RESAMPLE_OPS_ALL a cell-viewpoint and RESAMPLE_OPS_LIVE more
    for those that reach the search, at the float32 rate. The sorted
    columns' write and read back, a cost of the two-kernel design, are
    reported beside it (design_bytes). ``call_launches``: the launches
    phase 25 counted in its viewshed_count of COUNT_OBS viewpoints."""
    from horizonator_tpu_torch.kernels import build
    from horizonator_tpu_torch.kernels import viewshed_resample as vr
    from horizonator_tpu_torch.ops import viewshed as vs
    tanel, d, half, az_cols, _ = vs._march(
        dem, p, sampler="window", width=w, nsteps=k, cells_per_deg=CPD,
        surface="bilinear", lat_hint_deg=LAT, znear_hint_m=50.0, plain=False)
    b, _, kk = tanel.shape
    colv = torch.stack(torch.broadcast_tensors(
        torch.cos(az_cols), torch.sin(az_cols), half, half), -1).contiguous()
    obs = torch.stack(list(p), 1).contiguous()
    kw = dict(hw=hw, cell_n=vs.geometry.EARTH_RADIUS_M * vs.DEG / CPD,
              center=center, triangulated=False, full_circle=True)
    p2 = 2 * hw

    def counted(fn):
        total = torch.zeros((p2, p2), dtype=torch.int32, device=dem.device)
        fn(dem, tanel, d, obs, colv, total=total, **kw)
        return total
    vr.resample.launches = 0
    got = counted(vr.resample)
    launches = vr.resample.launches
    ref = counted(vr.resample_plain)
    if launches != 1:
        fail(f"config 10: {launches} resampler launches for one batch")
    if not torch.equal(got, ref):
        fail(f"config 10: resampler kernels != resample_plain in "
             f"{int((got != ref).sum())} cells")
    f = vs._frame(p, hw, center, CPD, w)
    pj = p.viewer_cell_j[:, None] + f["dj"]
    pi = p.viewer_cell_i[:, None] + f["di"]
    on_grid = (((pj >= 0) & (pj <= dem.shape[0] - 1))[:, :, None]
               & ((pi >= 0) & (pi <= dem.shape[1] - 1))[:, None, :])
    live = int((f["in_r"] & f["in_az"] & on_grid).sum())
    del f, pj, pi, on_grid
    ops = RESAMPLE_OPS_ALL * b * p2 * p2 + RESAMPLE_OPS_LIVE * live
    kp, ks = vr._padded(kk), vr._row_stride(kk)
    lib = build.library()

    def columns():
        ds = torch.empty((b, w, ks), device=dem.device)
        rn = torch.empty_like(ds)
        lib.hz_viewshed_columns(
            tanel.data_ptr(), d.data_ptr(), b, w, kk, kp, ks, ds.data_ptr(),
            rn.data_ptr(), torch.cuda.current_stream().cuda_stream)
        return ds, rn
    col_ms = graph_ms(columns, BATCH_GRAPH_LAUNCHES)
    both_ms = graph_ms(lambda: counted(vr.resample), BATCH_GRAPH_LAUNCHES)
    plain_ms = cuda_ms_run(lambda i: counted(vr.resample_plain), 2)
    nbytes = 2 * 4 * b * w * kk + 4 * dem.numel() + 2 * 4 * p2 * p2
    design = 2 * 2 * 4 * b * w * kk
    rec = kernel_entry(
        "viewshed_resample",
        "horizonator_tpu_torch/kernels/csrc/viewshed_resample.cu",
        None, launches, 0.0, both_ms, plain_ms, nbytes, ops, FP32_OPS_PER_S)
    rec.update(columns_ms=col_ms, design_bytes=design,
               live_cell_viewpoints=live, call_launches=call_launches)
    log(f"[25] resampler ({b}, {w}, {kk}) -> {p2}x{p2} count == "
        f"resample_plain bitwise, {launches} launch; device ms columns "
        f"{col_ms:.4f} + cells {both_ms - col_ms:.4f} = {both_ms:.4f} "
        f"({1e3 * both_ms / b:.2f} us an observer), bound "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']}: {nbytes / 1e9:.4f} GB, "
        f"{ops / 1e9:.3f} G ops, {live} of {b * p2 * p2} cell-viewpoints "
        f"live), share {100 * rec['bound_ms'] / both_ms:.1f}%; the sorted "
        f"columns' write and read back {design / 1e9:.4f} GB more "
        f"({design / HBM_BYTES_PER_S * 1e3:.4f} ms); plain ms {plain_ms:.2f}")
    return rec


def count_phase(dev, card, profile_dir=None):
    """Phase 25: suite config 10 (benchmarks/suite.py:357), viewshed_count
    of 256 observers (default_rng(5) positions in [420, 780]) over the fixed
    frame (600, 600), hw 400, W 720, batches of 64. Returns the batched
    march's record and the resampler's."""
    from horizonator_tpu_torch.kernels.viewshed_resample import resample
    from horizonator_tpu_torch.kernels.window_march import march
    from horizonator_tpu_torch.ops import viewshed_count, viewshed_grid
    from horizonator_tpu_torch.ops import viewshed as vs
    from horizonator_tpu_torch.render import RenderParams
    t0 = time.perf_counter()
    n, hw, w, batch = VS_N, VS_HW, VS_W, COUNT_BATCH
    dem = torch.from_numpy(bench_dem(n=n)).to(dev)
    pts = np.random.default_rng(5).uniform(*COUNT_SPREAD, (COUNT_OBS, 2))
    pts = pts.astype(np.float32)
    center = (COUNT_CENTER, COUNT_CENTER)
    kw = dict(out_center_ij=center, out_halfwidth=hw, width=w,
              cells_per_deg=CPD, znear=50.0, zfar=VS_ZFAR, lat_deg=LAT,
              batch=batch, device=dev)
    march.launches = resample.launches = 0
    counts, peak_mb = peak_run(lambda: viewshed_count(dem, pts, **kw))
    launches, resample_launches = march.launches, resample.launches
    chunks = -(-COUNT_OBS // batch)
    if resample_launches != chunks:
        fail(f"config 10: {resample_launches} resampler launches for "
             f"{chunks} batches")
    if (launches != chunks or counts.shape != (2 * hw, 2 * hw)
            or counts.dtype != torch.int32 or int(counts.max()) < 1
            or int(counts.max()) > COUNT_OBS or int(counts.min()) < 0):
        fail(f"config 10: launches {launches}, {tuple(counts.shape)} "
             f"{counts.dtype}, counts {int(counts.min())}.."
             f"{int(counts.max())}")
    if not torch.equal(counts, viewshed_count(dem, pts, plain=True, **kw)):
        fail("config 10: counts != the plain versions' (direct masked max)")
    dem_f, pts_t, vz, k, lat_hint, cos_lat = vs._sweep_prep(
        dem, pts, 2.0, nsteps=None, cells_per_deg=CPD, zfar=VS_ZFAR,
        cos_viewer_lat=None, lat_deg=LAT, device=dev)
    p = vs._observer_params(pts_t, vz, cos_lat, 50.0, VS_ZFAR)
    gkw = dict(width=w, nsteps=k, cells_per_deg=CPD, sampler="window",
               lat_hint_deg=lat_hint, znear_hint_m=50.0, out_halfwidth=hw,
               out_center_ij=center, full_circle=True)
    total = torch.zeros_like(counts)
    torch.cuda.synchronize()
    t1 = torch.cuda.Event(enable_timing=True)
    t2 = torch.cuda.Event(enable_timing=True)
    t1.record()
    for v in range(COUNT_OBS):
        total += viewshed_grid(dem_f, RenderParams(*(x[v] for x in p)),
                               **gkw).to(torch.int32)
    t2.record()
    t2.synchronize()
    loop = t1.elapsed_time(t2) / COUNT_OBS
    if not torch.equal(counts, total):
        fail(f"config 10: counts != the sum of {COUNT_OBS} single rasters: "
             f"{int((counts != total).sum())} cells")
    per_obs = cuda_ms(lambda i: viewshed_count(dem, pts, **kw), 3) / COUNT_OBS
    busy, in_call = profile_busy(lambda: viewshed_count(dem, pts, **kw), 2,
                                 card, profile_dir, "config10",
                                 f"2 counts of {COUNT_OBS} observers")
    busy_share = None if busy is None else busy / (per_obs * COUNT_OBS)
    log(f"[25] config 10: viewshed_count of {COUNT_OBS} observers, frame "
        f"{center} hw {hw}, W {w}, batches of {batch}: {launches} march "
        f"and {chunks} resampler launches, == plain versions' counts and == "
        f"the sum of "
        f"{COUNT_OBS} single rasters bitwise; counts 0..{int(counts.max())}"
        f", mean {float(counts.float().mean()):.2f}")
    log(f"[25] config 10: us per observer batched {1e3 * per_obs:.1f} "
        f"(median of 3 counts), single rasters {1e3 * loop:.1f} "
        f"({loop / per_obs:.1f}x); device busy {busy_text(busy_share)}"
        + (f", march {in_call:.4f} ms a launch" if in_call else "")
        + f"; peak device memory {peak_mb:.1f} MB")
    q = RenderParams(*(x[:batch] for x in p))
    rec = march_launch_record(
        "config 10", dem_f, q, w, k, n, LAT, launches // chunks, per_obs,
        loop, busy_share, peak_mb, chunks)
    res = resample_record(dem_f, q, w, k, hw, center, resample_launches)
    log(f"[t] phase 25: {time.perf_counter() - t0:.1f} s")
    return rec, res


def q16_azimuth(cpd, lat):
    """The first azimuth from SHADOW_Q16_FROM, in 0.1 deg steps, whose sun
    slope snaps to q = 16 taps at (cpd, lat)."""
    from horizonator_tpu_torch.ops.shadows import _ray_step
    for k in range(3600):
        az = round(SHADOW_Q16_FROM + 0.1 * k, 1)
        if _ray_step(cpd, lat, az, 16)[4] == 16:
            return az
    fail(f"no q = 16 sun at cpd {cpd}, lat {lat}")


def shadow_oracle_margin(z, cells, cpd, lat, az, alt):
    """Max blocker height above the sun ray (meters) at each of ``cells``
    ((m, 2) int64 (j, i) on z's device), by brute float64 bilinear
    sampling along the op's quantized ray (ops.shadows._ray_step), every
    step of a ray at once. Positive = shadowed."""
    from horizonator_tpu_torch.ops.shadows import _ray_step
    nj, ni = z.shape
    dj, di, h, _, _, _ = _ray_step(cpd, lat, az, 16)
    tan_alt = math.tan(math.radians(alt))
    zd = z.double()
    t = torch.arange(1, int(math.hypot(nj, ni)) + 2, device=z.device,
                     dtype=torch.float64)
    out = []
    for c in cells.split(256):
        jf = c[:, :1].double() + t * dj
        if_ = c[:, 1:].double() + t * di
        inside = (jf >= 0) & (jf <= nj - 1) & (if_ >= 0) & (if_ <= ni - 1)
        j0 = torch.clamp(torch.floor(jf), 0, nj - 2).long()
        i0 = torch.clamp(torch.floor(if_), 0, ni - 2).long()
        fj, fi = jf - j0, if_ - i0
        bil = ((1 - fj) * (1 - fi) * zd[j0, i0]
               + (1 - fj) * fi * zd[j0, i0 + 1]
               + fj * (1 - fi) * zd[j0 + 1, i0]
               + fj * fi * zd[j0 + 1, i0 + 1])
        s = bil - zd[c[:, 0], c[:, 1]][:, None] - t * (h * tan_alt)
        out.append(torch.where(inside, s, -math.inf).amax(dim=1))
    return torch.cat(out)


def shadow_phase(dev, card):
    """Phase 26: shadow_light at full size over phase 2's bench DEM (3400^2,
    cpd 1200, lat 34.3) and the SRTM1 tile (3601^2, cpd 3600, lat 34.5), at
    tests/test_shadows.py's six suns, a sun of q = 16 taps and one below
    the horizon: the class against a brute per-ray oracle at 4096 seeded
    cells (0.5 m margins, soft_m 1e-3), the card bitwise against the CPU
    at every sun, the median ms of each sun against its
    one-read-one-write bound; then sun_hours over the SRTM1 tile for one
    date against the CPU."""
    from horizonator_tpu_torch.ops.shadows import (_ray_step, shadow_light,
                                                   sun_hours)
    t0 = time.perf_counter()
    scenes = (("bench 3400^2", bench_dem(), CPD, LAT),
              ("SRTM1 3601^2", np.flipud(srtm1_grid()).astype(np.float32),
               3600, 34.5))
    for name, z_np, cpd, lat in scenes:
        z = torch.from_numpy(z_np).to(dev)
        z_cpu = torch.from_numpy(np.ascontiguousarray(z_np))
        nj, ni = z_np.shape
        cells = torch.from_numpy(np.random.default_rng(26).integers(
            0, (nj, ni), (SHADOW_ORACLE_CELLS, 2))).to(dev)
        suns = (*SHADOW_SUNS, (q16_azimuth(cpd, lat), 20.0), (90.0, -3.0))
        for az, alt in suns:
            kw = dict(cells_per_deg=cpd, lat_deg=lat, sun_az_deg=az,
                      sun_alt_deg=alt)
            hard = shadow_light(z, soft_m=1e-3, **kw)
            n_diff = int((hard.cpu() != shadow_light(
                z_cpu, soft_m=1e-3, **kw)).sum())
            if n_diff:
                fail(f"shadow_light on {name} at sun ({az}, {alt}): "
                     f"card != CPU at {n_diff} cells")
            q = _ray_step(cpd, lat, az, 16)[4]
            if alt <= 0.0:
                if bool(hard.any()):
                    fail(f"sun below the horizon lit {name}")
                passes, shadowed, lit = 0, 0, 0
            else:
                margin = shadow_oracle_margin(z, cells, cpd, lat, az, alt)
                light = hard[cells[:, 0], cells[:, 1]]
                sh, li = margin > 0.5, margin < -0.5
                if bool((light[sh] >= 0.5).any()) or \
                        bool((light[li] <= 0.5).any()):
                    fail(f"shadow_light on {name} at sun ({az}, {alt}): "
                         f"{int((light[sh] >= 0.5).sum())} clearly shadowed "
                         f"cells lit, {int((light[li] <= 0.5).sum())} "
                         f"clearly lit cells dark (oracle)")
                n_dom = nj if abs(round(q * _ray_step(cpd, lat, az, 16)[0])) \
                    == q else ni
                passes = q + max(-(-n_dom // q) - 1, 1).bit_length()
                shadowed, lit = int(sh.sum()), int(li.sum())
            ms = cuda_ms(lambda i: shadow_light(z, **kw), 5)
            dark = float((hard < 0.5).float().mean())
            # z read once and the light written once; a sun below the
            # horizon writes zeros and reads nothing
            moved = (8 if alt > 0.0 else 4) * z.numel()
            bound_ms = moved / HBM_BYTES_PER_S * 1e3
            log(f"[26] shadow_light {name} sun ({az:g}, {alt:g}): q {q}, "
                f"{passes} passes; card == CPU bitwise (0 cells differ); "
                f"oracle at {SHADOW_ORACLE_CELLS} cells: {shadowed} clearly "
                f"shadowed dark, {lit} clearly lit lit; shadowed "
                f"{100 * dark:.2f}%; {ms:.3f} ms (median of 5), "
                f"bound {bound_ms:.4f} ms ({moved / 1e6:.1f} MB), share "
                f"{100 * bound_ms / ms:.2f}%; {card}")
        del z, z_cpu
    # sun_hours over the SRTM1 tile: one date
    z_np, cpd, lat = scenes[1][1], scenes[1][2], scenes[1][3]
    z = torch.from_numpy(z_np).to(dev)
    skw = dict(cells_per_deg=cpd, lat_deg=lat, lon_deg=-117.5,
               date=SUN_HOURS_DATE, samples=SUN_HOURS_SAMPLES)
    hours = sun_hours(z, **skw)
    hours_cpu = sun_hours(torch.from_numpy(np.ascontiguousarray(z_np)), **skw)
    n_diff = int((hours.cpu() != hours_cpu).sum())
    if n_diff or not (0.0 <= float(hours.min())
                      and float(hours.max()) <= 24.0):
        fail(f"sun_hours: card != CPU at {n_diff} cells, range "
             f"{float(hours.min())}..{float(hours.max())}")
    ms_h = cuda_ms(lambda i: sun_hours(z, **skw), 3, warmup=1)
    log(f"[26] sun_hours SRTM1 3601^2 on {skw['date']}, {skw['samples']} "
        f"instants: card == CPU bitwise; {float(hours.min()):.2f}.."
        f"{float(hours.max()):.2f} h, mean {float(hours.mean()):.3f}; "
        f"{ms_h:.3f} ms (median of 3); {card}")
    log(f"[t] phase 26: {time.perf_counter() - t0:.1f} s")


def write_pois(path, lat, lon, n, seed):
    """n seeded POIs around (lat, lon) as a --pois JSON file; returns the
    list."""
    rng = np.random.default_rng(seed)
    pois = [{"name": f"poi{k}", "lat": float(lat + rng.uniform(-0.3, 0.3)),
             "lon": float(lon + rng.uniform(-0.35, 0.35)),
             "ele_m": float(rng.uniform(300.0, 2500.0))} for k in range(n)]
    with open(path, "w") as f:
        json.dump(pois, f)
    return pois


def api_shadow_phase(dev, card, tiles):
    """Phase 27: the API with hillshade=True, shadows=True (sun 10 deg up)
    on phase 6's tiles at 4096x1024: both textured kernels launched, image
    and ranges bitwise the plain versions' render on the same planes,
    ranges bitwise the unshadowed hillshade render's, terrain darker; the
    planes' set-up ms; then the CLI in-process with --hillshade --shadows
    --pois --pois-out (to .pdf: the card's machine has no PIL), its
    GeoJSON's flags against visible_peaks."""
    from horizonator_tpu_torch import cli, horizonator
    from horizonator_tpu_torch.kernels.resolve import resolve_textured
    from horizonator_tpu_torch.kernels.window_march import march_textured
    from horizonator_tpu_torch.render import render_panorama, texture
    t0 = time.perf_counter()
    hkw = dict(dir_dems=tiles, hillshade=True, sun_alt_deg=10.0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    h = horizonator(34.4, -117.6, W, H, shadows=True, **hkw)
    torch.cuda.synchronize()
    setup_ms = 1e3 * (time.perf_counter() - t1)
    march_textured.launches = resolve_textured.launches = 0
    img, rng = h.render(-180, 180)
    launches = {"window_march_textured": march_textured.launches,
                "resolve_textured": resolve_textured.launches}
    if min(launches.values()) < 1:
        fail(f"shadowed API render skipped a kernel: {launches}")
    dem, sampler, nsteps, plan, cp, exact_near = h._render_plan(
        100.0, 40000.0, "render")
    p_api = h._params(-180.0, 180.0, 100.0, 40000.0, 100.0, 40000.0)
    img_p, rng_p = render_panorama(
        dem, p_api, width=W, height=H, nsteps=nsteps,
        cells_per_deg=h.mosaic.cells_per_deg, surface=h.surface,
        refine=h.refine, textured=True, sampler=sampler,
        lat_hint_deg=h._lat_hint(), lod_plan=plan, color_planes=cp,
        znear_hint_m=h._znear_hint(100.0), exact_near_m=exact_near,
        plain=True)
    if not (np.array_equal(img, img_p.cpu().numpy())
            and np.array_equal(rng, rng_p.cpu().numpy())):
        fail("shadowed API render != plain-version render")
    h0 = horizonator(34.4, -117.6, W, H, **hkw)
    img0, rng0 = h0.render(-180, 180)
    terr = rng > 0
    darker = int((img[terr] < img0[terr]).any(axis=-1).sum())
    if not np.array_equal(rng, rng0):
        fail(f"shadows moved the ranges: {int((rng != rng0).sum())} pixels")
    if (img[terr] > img0[terr]).any() or darker < 1:
        fail(f"shadows did not only darken: {darker} pixels darker, "
             f"{int((img[terr] > img0[terr]).any(axis=-1).sum())} lighter")
    n = h.mosaic.grid.shape[0]
    pkw = dict(sun_az_deg=h.sun_az_deg, sun_alt_deg=h.sun_alt_deg, scale=1)
    ms_planes = cuda_ms(lambda i: texture.hillshade_planes(
        h._dem, h.mosaic.cells_per_deg, 34.4, cast_shadows=True, **pkw), 3)
    ms_planes0 = cuda_ms(lambda i: texture.hillshade_planes(
        h._dem, h.mosaic.cells_per_deg, 34.4, **pkw), 3)
    ms_render = cuda_ms(lambda i: h.render(-180 + i, 180 + i), 5, warmup=1)
    log(f"[27] API hillshade=True, shadows=True, sun ({h.sun_az_deg:g}, "
        f"{h.sun_alt_deg:g}) {W}x{H} of {n}^2 grid: launches {launches}, "
        f"image and ranges == plain-version render bitwise, ranges == the "
        f"unshadowed render's, {darker} of {int(terr.sum())} terrain pixels "
        f"darker, none lighter; {ms_render:.3f} ms per render (median of "
        f"5); set-up {setup_ms:.1f} ms (constructor, tiles read from disk), "
        f"the planes {ms_planes:.3f} ms with shadows, {ms_planes0:.3f} "
        f"without (median of 3); {card}")
    del h, h0
    with tempfile.TemporaryDirectory() as td:
        pois_path = os.path.join(td, "pois.json")
        write_pois(pois_path, 34.4, -117.6, POIS_N, 27)
        out, pdf = os.path.join(td, "peaks.geojson"), os.path.join(td, "x.pdf")
        march_textured.launches = resolve_textured.launches = 0
        t1 = time.perf_counter()
        rc = cli.main(["--width", str(W), "--height", str(H), "--image", pdf,
                       "--dirdems", tiles, "--hillshade", "--shadows",
                       "--sun-alt", "10", "--pois", pois_path, "--pois-out",
                       out, "34.4", "-117.6", "0", "180"])
        cli_s = time.perf_counter() - t1
        launches = {"window_march_textured": march_textured.launches,
                    "resolve_textured": resolve_textured.launches}
        if rc != 0 or min(launches.values()) < 1:
            fail(f"CLI --shadows --pois-out rc {rc}, launches {launches}")
        with open(out) as f:
            feats = json.load(f)["features"]
        # the CLI's instance: render_radius_m = zfar (standalone.c:437)
        peaks = horizonator(34.4, -117.6, W, H, dir_dems=tiles,
                            render_radius_m=40000.0,
                            device=dev).visible_peaks(pois_path)
        flags = [f["properties"]["visible"] for f in feats]
        if flags != [p["visible"] for p in peaks] or not 0 < sum(flags) \
                < len(flags):
            fail(f"--pois-out flags != visible_peaks ({sum(flags)} of "
                 f"{len(flags)} visible)")
    log(f"[27] CLI --hillshade --shadows --pois ({POIS_N}) --pois-out "
        f"{W}x{H} -> .pdf + .geojson in {cli_s:.2f} s: rc 0, launches "
        f"{launches}, {sum(flags)} of {len(flags)} POIs visible, flags == "
        f"visible_peaks'")
    log(f"[t] phase 27: {time.perf_counter() - t0:.1f} s")


def los_phase(dev, card, tiles):
    """Phase 28: visible_peaks of 512 seeded POIs (config 2's count) on
    phase 6's scene, the card against the CPU; intervisibility_matrix of
    256 seeded points over phase 2's bench DEM at the auto K: symmetric,
    diagonal true, 16 rows equal to the CPU's; chunks, peak memory against
    the budget, ms against a bound of two packed gathers a sample. The
    points stand on 100 m towers: at 2 m the bench grid's 30 m noise
    hides 99.6% of the pairs, at 100 m about 90%."""
    from horizonator_tpu_torch import horizonator
    from horizonator_tpu_torch.ops import los
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        pois_path = os.path.join(td, "pois.json")
        pois = write_pois(pois_path, 34.4, -117.6, POIS_N, 28)
    h = horizonator(34.4, -117.6, W, H, dir_dems=tiles, device=dev)
    hc = horizonator(34.4, -117.6, W, H, dir_dems=tiles, device="cpu")
    peaks = h.visible_peaks(pois)
    if peaks != hc.visible_peaks(pois):
        fail("visible_peaks on the card != on the CPU")
    n_vis = sum(p["visible"] for p in peaks)
    if not 0 < n_vis < POIS_N:
        fail(f"degenerate visible_peaks: {n_vis} of {POIS_N}")
    ms_vp = cuda_ms(lambda i: h.visible_peaks(pois), 5)
    log(f"[28] visible_peaks of {POIS_N} POIs on {h.mosaic.grid.shape} grid: "
        f"{n_vis} visible, card == CPU (flags, floats bitwise); {ms_vp:.3f} "
        f"ms (median of 5); {card}")
    del h, hc
    dem_np = bench_dem()
    dem = torch.from_numpy(dem_np).to(dev)
    pts = np.random.default_rng(28).uniform(0, N - 1, (LOS_POINTS, 2))
    pts = pts.astype(np.float32)
    k = los.auto_nsteps(pts)
    kw = dict(cells_per_deg=CPD, cos_lat=math.cos(math.radians(LAT)),
              observer_height_m=100.0)
    m, peak_mb = peak_run(lambda: los.intervisibility_matrix(dem, pts, **kw))
    pairs = LOS_POINTS * LOS_POINTS
    chunk = max(1, los.LOS_BYTES // (k * los.LOS_SAMPLE_BYTES))
    per_sample = peak_mb * 1e6 / (min(chunk, pairs) * k)
    if peak_mb * 1e6 > los.LOS_BYTES or per_sample > los.LOS_SAMPLE_BYTES:
        fail(f"intervisibility_matrix peak {peak_mb:.1f} MB over the "
             f"{los.LOS_BYTES / 1e6:.1f} MB budget, or its "
             f"{per_sample:.1f} B a sample over the estimate "
             f"{los.LOS_SAMPLE_BYTES}")
    if not (bool(torch.equal(m, m.T)) and bool(m.diagonal().all())):
        fail("intervisibility_matrix not symmetric with a true diagonal")
    rows = np.arange(LOS_CHECK_ROWS) * (LOS_POINTS // LOS_CHECK_ROWS)
    m_cpu = los.intervisible(torch.from_numpy(dem_np), pts[rows, None, :],
                             pts[None, :, :], nsteps=k, target_height_m=100.0,
                             **kw)
    m_cpu |= torch.from_numpy(rows[:, None] == np.arange(LOS_POINTS))
    if not torch.equal(m[torch.from_numpy(rows).to(dev)].cpu(), m_cpu):
        fail(f"intervisibility_matrix rows {rows.tolist()} != the CPU's")
    ms = cuda_ms(lambda i: los.intervisibility_matrix(dem, pts, **kw), 3,
                 warmup=1)
    samples = pairs * k
    bound_ms = 8 * samples / HBM_BYTES_PER_S * 1e3
    log(f"[28] intervisibility_matrix {LOS_POINTS} points over {N}^2 at the "
        f"auto K {k}: {samples / 1e6:.1f} M samples, {-(-pairs // chunk)} "
        f"chunks of {chunk} pairs, symmetric, diagonal true, "
        f"{float(m.float().mean()):.4f} visible, {LOS_CHECK_ROWS} rows == "
        f"CPU bitwise; peak {peak_mb:.1f} MB of the "
        f"{los.LOS_BYTES / 1e6:.1f} MB budget ({per_sample:.1f} B a sample "
        f"of the {los.LOS_SAMPLE_BYTES} estimated); {ms:.3f} ms (median of "
        f"3), "
        f"bound {bound_ms:.3f} ms (bytes: 2 packed gathers a sample), share "
        f"{100 * bound_ms / ms:.2f}%; {card}")
    log(f"[t] phase 28: {time.perf_counter() - t0:.1f} s")


def step_budget_api(zfar, znear, cpd=CPD):
    """The API's uniform-step budget (api.py:398-405): cell/oversample
    spacing over [znear, zfar], a multiple of 256 in [256, 8192]."""
    cell_n = 6371000.0 * math.pi / 180.0 / cpd
    n = (zfar - znear) / cell_n * STEP_OVERSAMPLE
    return max(256, min(8192, -(-int(math.ceil(n)) // 256) * 256))


def oracle_render_check(tag, render, counters):
    """One render of an oracle path with every kernel count at 0 just
    before it, read just after; the image and ranges bitwise the plain
    versions' render. Returns (image, ranges, launches)."""
    for fn in counters:
        fn.launches = 0
    img, rng = render(False)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) < 1:
        fail(f"{tag}: a kernel of the path was not launched: {launches}")
    vis = float((rng > 0).float().mean())
    if not 0.05 < vis < 0.95:
        fail(f"{tag}: degenerate visible fraction {vis}")
    img_p, rng_p = render(True)
    if not (torch.equal(img, img_p) and torch.equal(rng, rng_p)):
        fail(f"{tag}: render != the plain versions' render: "
             f"{int((rng != rng_p).sum())} ranges differ")
    return img, rng, launches


def resolve_record(cell, p, tanel, height, launches, int32_rate):
    """The resolve kernel alone at an oracle path's shape: its rows from
    the path's raw tangents, bitwise against its plain version, device ms
    (graph replay), plain ms and bound as phase 5 counts them."""
    from horizonator_tpu_torch.kernels.resolve import resolve, resolve_plain
    from horizonator_tpu_torch.render.raymarch import horizon_rows
    from horizonator_tpu_torch.render.resolve_window import alpha_quantum
    w = tanel.shape[-2]
    y = horizon_rows(tanel, p, width=w, height=height).reshape(
        -1, tanel.shape[-1]).contiguous()
    amax, int_first = alpha_quantum(y.shape[1], height)
    got = resolve(y, height, amax, int_first)
    ref = resolve_plain(y, height, amax, int_first)
    for name, a, b in zip(("idx", "alpha", "ok"), got, ref):
        if not torch.equal(a, b):
            fail(f"{cell}: resolve {name} != plain at {tuple(y.shape)}")
    ms = graph_ms(lambda: resolve(y, height, amax, int_first),
                  GRAPH_LAUNCHES)
    plain_ms = cuda_ms_run(lambda i: resolve_plain(y, height, amax,
                                                   int_first), 5)
    nbytes = y.nbytes + 9 * y.shape[0] * height
    ops = y.shape[0] * (4 * y.shape[1] + 12 * height)
    b_ms, b_by = bound(nbytes, ops, int32_rate)
    log(f"[{cell}] resolve ({y.shape[0]}, {y.shape[1]}) -> H {height} "
        f"(amax {amax:g}, {'fused' if int_first else 'fallback'} alpha "
        f"regime) == plain bitwise; device ms {ms:.4f} (plain "
        f"{plain_ms:.3f}), bound {b_ms:.5f} ({b_by}), share "
        f"{100 * b_ms / ms:.1f}%")
    return dict(cell=cell, k=int(y.shape[1]), launches=launches, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def card_vs_cpu(tag, got, ref, same_cols):
    """A card result against the same function on CPU tensors: bitwise in
    ``same_cols``, the columns whose sin and cos of az the two devices
    round alike (every other operation is IEEE-rounded on both); elsewhere
    printed: the count of values that differ and their largest difference
    where both are valid (a sanity bound of 1e-3), and the samples valid
    on one device only (at most 1e-4 of them)."""
    got = got.cpu()
    diff = got != ref
    gv, rv = got > -1e30, ref > -1e30
    both = gv & rv
    err = float((got[both].double() - ref[both].double()).abs().max())
    flips = int((gv != rv).sum())
    if diff[same_cols.cpu()].any():
        fail(f"{tag}: card != CPU in columns whose sin and cos agree")
    if err > 1e-3 or flips > 1e-4 * diff.numel():
        fail(f"{tag}: card vs CPU: error {err}, {flips} validity flips")
    log(f"[{tag}] card vs CPU: bitwise in the {int(same_cols.sum())} of "
        f"{same_cols.numel()} columns whose sin and cos agree; elsewhere "
        f"{int(diff.sum())} of {diff.numel()} values differ, max {err:.3e} "
        f"where both are valid, {flips} valid on one device only")


def same_trig_cols(az):
    """Columns whose sin and cos of az the card rounds as the CPU does."""
    c = az.cpu()
    return ((torch.sin(az).cpu() == torch.sin(c))
            & (torch.cos(az).cpu() == torch.cos(c)))


def planar_oracle(tag, tanel, d, az):
    """Phase 4's planar-DEM analytic oracle on a march's samples: the
    tangent error within 4e-3."""
    d_np = d.cpu().numpy().astype(np.float64)
    t_np = tanel.cpu().numpy().astype(np.float64)
    az_np = az.cpu().numpy().astype(np.float64)
    cell_n = 6371000.0 * math.pi / 180.0 / CPD
    cell_e = cell_n * math.cos(math.radians(34.0))
    g = PLANE[1] * np.sin(az_np) / cell_e + PLANE[2] * np.cos(az_np) / cell_n
    valid = (t_np > -1e30) & (d_np >= 100.0)
    err = float(np.abs((t_np - (g[:, None] - PLANE[3] / np.maximum(
        d_np, 1.0))) * valid).max())
    if not valid.sum() or err > 4e-3:
        fail(f"{tag}: planar-DEM oracle error {err} (budget 4e-3)")
    log(f"[{tag}] planar-DEM analytic oracle: max tangent error {err:.3e} "
        f"over {int(valid.sum())} samples (budget 4e-3)")


def planar_scene(dev):
    """Phase 4's plane (z0 + a i + b j, viewer dz0 above it)."""
    from horizonator_tpu_torch.render import make_params
    n4 = 512
    jj, ii = np.meshgrid(np.arange(n4, dtype=np.float32),
                         np.arange(n4, dtype=np.float32), indexing="ij")
    z0, a_sl, b_sl, dz0 = PLANE
    dem = torch.from_numpy((z0 + a_sl * ii + b_sl * jj).astype(
        np.float32)).to(dev)
    p = make_params(device=dev, viewer_cell_i=255.3, viewer_cell_j=257.6,
                    viewer_z=z0 + a_sl * 255.3 + b_sl * 257.6 + dz0,
                    cos_viewer_lat=math.cos(math.radians(34.0)),
                    az_rad0=-math.pi, az_rad1=math.pi, znear=100.0,
                    zfar=6000.0, znear_color=100.0, zfar_color=6000.0)
    return dem, p


def bench_view(dev, i=0):
    """Phase 2's bench viewpoint, moved by i cells."""
    from horizonator_tpu_torch.render import make_params
    return make_params(
        device=dev, viewer_cell_i=N / 2 + i, viewer_cell_j=N / 2 - i,
        viewer_z=900.0, cos_viewer_lat=math.cos(math.radians(LAT)),
        az_rad0=-math.pi, az_rad1=math.pi, znear=100.0, zfar=ZFAR,
        znear_color=100.0, zfar_color=ZFAR)


def step_phase(dev, card, int32_rate):
    """Phase 29: the uniform-step sampler at the bench shape (phase 2's
    scene, 4096x1024, 360 deg, zfar 40 km, the API's budget K 768).
    Returns the resolve's records."""
    from horizonator_tpu_torch.kernels.resolve import resolve
    from horizonator_tpu_torch.parallel import horizon_batch
    from horizonator_tpu_torch.render import render_panorama
    from horizonator_tpu_torch.render.raymarch import (march_tanel,
                                                       pack_dem_pairs)
    from horizonator_tpu_torch.render.resolve_window import resolve_fits
    t0 = time.perf_counter()
    dem = torch.from_numpy(bench_dem()).to(dev)
    packed = pack_dem_pairs(dem)
    k = step_budget_api(ZFAR, 100.0)
    p = bench_view(dev)
    records = []
    for surface in ("bilinear", "triangulated"):
        for kk in ((k, STEP_K_WIDE) if surface == "bilinear" else (k,)):
            kw = dict(width=W, height=H, nsteps=kk, cells_per_deg=CPD,
                      sampler="step", surface=surface)
            tag = f"29 step {surface} K {kk}"
            img, rng, launches = oracle_render_check(
                tag, lambda plain: render_panorama(packed, p, plain=plain,
                                                   **kw), [resolve])
            log(f"[{tag}] render {W}x{H}: launches {launches}, visible "
                f"{float((rng > 0).float().mean()):.4f}, image and ranges "
                f"== plain versions' render bitwise (resolve_fits "
                f"{resolve_fits(kk, H)})")
            if surface == "bilinear":
                tanel = march_tanel(packed, p, width=W, nsteps=kk,
                                    cells_per_deg=CPD)[0]
                records.append(resolve_record(
                    f"step K {kk}", p, tanel, H, launches["resolve"],
                    int32_rate))
                del tanel
    dem4, p4 = planar_scene(dev)
    tan4, _, d4, az4 = march_tanel(dem4, p4, width=512, nsteps=1024,
                                   cells_per_deg=CPD)
    planar_oracle("29 step", tan4, d4[None, :].expand_as(tan4), az4)

    # the march on the card against the same function on CPU tensors
    tan_c, _, d_c, az_c = march_tanel(packed, p, width=W, nsteps=k,
                                      cells_per_deg=CPD,
                                      surface="triangulated")
    tan_h, _, d_h, _ = march_tanel(packed.cpu(), bench_view("cpu"), width=W,
                                   nsteps=k, cells_per_deg=CPD,
                                   surface="triangulated")
    if not torch.equal(d_c.cpu(), d_h):
        fail("29: step distances card != CPU")
    card_vs_cpu("29 march_tanel", tan_c, tan_h, same_trig_cols(az_c))
    del tan_c, tan_h
    rng_np = np.random.default_rng(29)
    vi = rng_np.uniform(0.25 * N, 0.75 * N, HB_VIEWS)
    vj = rng_np.uniform(0.25 * N, 0.75 * N, HB_VIEWS)
    hb = dict(width=HB_W, nsteps=k, cells_per_deg=CPD)
    pb = batch_params(dev, vi, vj, 900.0, LAT, -180.0, 180.0, 100.0, ZFAR)
    az_b, h_b = horizon_batch(packed, pb, **hb)
    az_h, h_h = horizon_batch(packed.cpu(), batch_params(
        "cpu", vi, vj, 900.0, LAT, -180.0, 180.0, 100.0, ZFAR), **hb)
    if not torch.equal(az_b.cpu(), az_h):
        fail("29: horizon_batch azimuths card != CPU")
    card_vs_cpu("29 horizon_batch", h_b[..., None], h_h[..., None],
                same_trig_cols(az_b))

    params = [bench_view(dev, i) for i in range(RENDERS + 2)]
    kw = dict(width=W, height=H, nsteps=k, cells_per_deg=CPD,
              sampler="step")
    ms = cuda_ms(lambda i: render_panorama(packed, params[i], **kw), RENDERS)
    _, peak_mb = peak_run(lambda: render_panorama(packed, p, **kw))
    ms_tri = cuda_ms(lambda i: render_panorama(
        packed, params[i], surface="triangulated", **kw), RENDERS)
    log(f"[29] step render {W}x{H} K {k}: ms/viewpoint (median of "
        f"{RENDERS}, CUDA events) bilinear {ms:.3f}, triangulated "
        f"{ms_tri:.3f}; peak device memory {peak_mb:.1f} MB; {card}")
    log(f"[t] phase 29: {time.perf_counter() - t0:.1f} s")
    return records


def crossing_phase(dev, card, int32_rate):
    """Phase 30: the grid-crossing sampler at the bench shape (K 576 + 4),
    its horizons against a dense step horizon and the window march's, the
    oracle viewsheds at configs 5 and 7, and the CLI's --viewshed-sampler
    crossing and --surface triangulated. Returns the resolve's record."""
    from horizonator_tpu_torch import cli, horizonator
    from horizonator_tpu_torch.kernels.resolve import resolve
    from horizonator_tpu_torch.ops import viewshed_grid, viewshed_sweep
    from horizonator_tpu_torch.render import render_panorama
    from horizonator_tpu_torch.render.crossing import (
        N_NEAR, horizon_crossing, k_cross_for, march_crossing, pack_scene)
    from horizonator_tpu_torch.render.raymarch import horizon_profile
    from horizonator_tpu_torch.render.window import march_window
    t0 = time.perf_counter()
    dem = torch.from_numpy(bench_dem()).to(dev)
    scene = pack_scene(dem)
    k = k_cross_for(ZFAR, CPD, LAT, n=N)
    p = bench_view(dev)
    kw = dict(width=W, height=H, nsteps=k, cells_per_deg=CPD,
              sampler="crossing")
    img, rng, launches = oracle_render_check(
        "30 crossing", lambda plain: render_panorama(scene, p, plain=plain,
                                                     **kw), [resolve])
    tanel = march_crossing(scene, p, width=W, k_cross=k,
                           cells_per_deg=CPD)[0]
    log(f"[30] crossing render {W}x{H} K {N_NEAR}+{k}: launches {launches},"
        f" visible {float((rng > 0).float().mean()):.4f}, == plain "
        f"versions' render bitwise")
    record = resolve_record(f"crossing K {N_NEAR + k}", p, tanel, H,
                            launches["resolve"], int32_rate)
    del tanel
    params = [bench_view(dev, i) for i in range(RENDERS + 2)]
    ms = cuda_ms(lambda i: render_panorama(scene, params[i], **kw), RENDERS)
    _, peak_mb = peak_run(lambda: render_panorama(scene, p, **kw))
    log(f"[30] crossing render {W}x{H}: ms/viewpoint (median of {RENDERS}, "
        f"CUDA events) {ms:.3f}; peak device memory {peak_mb:.1f} MB; {card}")
    dem4, p4 = planar_scene(dev)
    tan4, _, dists4, az4 = march_crossing(
        pack_scene(dem4), p4, width=512,
        k_cross=k_cross_for(6000.0, CPD, 34.0, n=512), cells_per_deg=CPD)
    idx4 = torch.arange(tan4.shape[1], device=dev).expand(512, -1)
    planar_oracle("30 crossing", tan4, dists4.d_of(idx4), az4)

    # horizons: against a dense uniform-step march (4 steps a cell) and the
    # window march, tests/test_crossing.py:70-97's bounds
    _, h_c = horizon_crossing(scene, p, width=W, k_cross=k,
                              cells_per_deg=CPD)
    dense = -(-4 * k // 256) * 256
    _, h_s = horizon_profile(dem, p, width=W, nsteps=dense,
                             cells_per_deg=CPD)
    h_w = march_window(dem, p, width=W, k_cross=k, cells_per_deg=CPD,
                       lat_hint_deg=LAT)[0].amax(dim=1)
    for name, ref in ((f"dense step (K {dense})", h_s), ("window", h_w)):
        a, b = h_c.cpu().numpy(), ref.cpu().numpy()
        vis = (a > -1e30) & (b > -1e30)
        agree = float(np.mean((a > -1e30) == (b > -1e30)))
        err = np.abs(np.arctan(a[vis]) - np.arctan(b[vis]))
        med, p99 = float(np.median(err)), float(np.percentile(err, 99))
        if agree <= 0.99 or med >= 6e-4 or p99 >= 1.5e-2:
            fail(f"30: horizon_crossing vs {name}: agree {agree}, median "
                 f"{med}, p99 {p99}")
        log(f"[30] horizon_crossing vs {name}: columns agree {agree:.4f}, "
            f"elevation error median {med:.2e} rad (bound 6e-4), p99 "
            f"{p99:.2e} (bound 1.5e-2)")

    # config 5's shape: viewshed_sweep with its default, the crossing march
    n = VS_N
    vdem = bench_dem(n=n)
    ii, jj = np.meshgrid(np.linspace(100, n - 100, SWEEP_GRID),
                         np.linspace(100, n - 100, SWEEP_GRID))
    pts = np.stack([ii.ravel(), jj.ravel()], 1)
    skw = dict(width=SWEEP_W, cells_per_deg=CPD, zfar=VS_ZFAR, lat_deg=LAT,
               device=dev)
    hz, peak_mb = peak_run(lambda: viewshed_sweep(vdem, pts, **skw))
    pick = np.linspace(0, len(pts) - 1, ORACLE_SINGLES).astype(int)
    for v in pick:
        one = viewshed_sweep(vdem, pts[v:v + 1], **skw)
        if not torch.equal(one[0], hz[v]):
            fail(f"30 config 5: viewpoint {v} != its single sweep")
    if not (hz > -1e30).all():
        fail("30 config 5: columns without a horizon")
    us = 1e3 * cuda_ms(lambda i: viewshed_sweep(vdem, pts, **skw), 3) / len(
        pts)
    log(f"[30] config 5: viewshed_sweep (crossing, the default) of "
        f"{len(pts)} viewpoints W {SWEEP_W}: == {ORACLE_SINGLES} single "
        f"sweeps bitwise; {us:.2f} us per viewpoint (median of 3), peak "
        f"device memory {peak_mb:.1f} MB; {card}")

    # config 7's shape: the oracle rasters
    vdem_t = torch.from_numpy(vdem).to(dev)
    from horizonator_tpu_torch.render import make_params
    pv = make_params(device=dev, viewer_cell_i=n / 2, viewer_cell_j=n / 2,
                     viewer_z=900.0, cos_viewer_lat=math.cos(math.radians(
                         LAT)), az_rad0=-math.pi, az_rad1=math.pi,
                     znear=50.0, zfar=VS_ZFAR, znear_color=50.0,
                     zfar_color=VS_ZFAR)
    gkw = dict(width=VS_W, cells_per_deg=CPD, out_halfwidth=VS_HW,
               lat_hint_deg=LAT, full_circle=True)
    cases = (("step (gather, the default)", dict(
        nsteps=step_budget_api(VS_ZFAR, 50.0))),
        ("crossing (contract)", dict(sampler="crossing", nsteps=k_cross_for(
            VS_ZFAR, CPD, LAT, n=n))))
    rasters = {}
    for name, extra in cases:
        vis, peak_mb = peak_run(lambda: viewshed_grid(vdem_t, pv, **gkw,
                                                      **extra))
        share = float(vis.float().mean())
        if vis.shape != (2 * VS_HW, 2 * VS_HW) or not 0.02 < share < 0.98:
            fail(f"30 config 7 {name}: {tuple(vis.shape)}, visible {share}")
        ms = cuda_ms(lambda i: viewshed_grid(vdem_t, pv, **gkw, **extra), 5)
        rasters[name] = vis
        log(f"[30] config 7 {name}: {2 * VS_HW}x{2 * VS_HW} raster, visible "
            f"{share:.4f}, {ms:.3f} ms per raster (median of 5), peak "
            f"device memory {peak_mb:.1f} MB")
    a, b = rasters.values()
    log(f"[30] config 7: the step and crossing rasters differ in "
        f"{float((a != b).float().mean()):.4%} of cells")

    with tempfile.TemporaryDirectory() as td:
        write_tiles(td, 34, -118)
        cli_viewshed_check(dev, sampler="crossing")
        out, npy = os.path.join(td, "tri.pdf"), os.path.join(td, "tri.npy")
        resolve.launches = 0
        rc = cli.main(["--width", str(W), "--height", str(H), "--image", out,
                       "--ranges", npy, "--dirdems", td, "--surface",
                       "triangulated", "34.4", "-117.6", "0", "180"])
        if rc != 0 or resolve.launches < 1:
            fail(f"30 CLI --surface triangulated rc {rc}, resolve launches "
                 f"{resolve.launches}")
        r_cli = np.load(npy)
        h = horizonator(34.4, -117.6, W, H, dir_dems=td,
                        render_radius_m=40000.0, surface="triangulated")
        r_api = h.render(-180, 180)[1]
        if h.sampler != "step" or not np.array_equal(r_cli, r_api):
            fail(f"30 CLI --surface triangulated ranges != the API's "
                 f"render ({h.sampler}): {int((r_cli != r_api).sum())}")
    log(f"[30] CLI --surface triangulated {W}x{H} -> .pdf + --ranges .npy: "
        f"rc 0, ranges == the API's surface='triangulated' render bitwise")
    log(f"[t] phase 30: {time.perf_counter() - t0:.1f} s")
    return record


def config1_scene(dev):
    """tests/test_mesh.py:96-145's scene: a 1201^2 grid, its viewpoint."""
    from horizonator_tpu_torch.render import make_params
    n = C1_N
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (600.0 + 500.0 * np.sin(ii / 223.0) * np.cos(jj / 181.0)
         + 200.0 * np.sin(ii / 37.0 + 1.3) * np.cos(jj / 53.0))
    dem = np.maximum(z, 0.0).astype(np.float32)
    vz = float(dem[599:601, 600:602].max()) + 2.0
    p = make_params(device=dev, viewer_cell_i=600.3, viewer_cell_j=599.7,
                    viewer_z=vz, cos_viewer_lat=math.cos(math.radians(
                        C1_LAT)), az_rad0=math.radians(-60.0),
                    az_rad1=math.radians(60.0), znear=100.0, zfar=C1_ZFAR,
                    znear_color=100.0, zfar_color=C1_ZFAR)
    return torch.from_numpy(dem).to(dev), p


def first_rows(r):
    vis = r > 0
    any_ = vis.any(axis=0)
    return np.where(any_, vis.argmax(axis=0), r.shape[0]), any_


def mesh_phase(dev, card, int32_rate):
    """Phase 31: suite config 1 and the mesh parity (the JAX package's
    slow test tests/test_mesh.py:96-145, on the card). Returns the window
    march's record of config 1's render."""
    from horizonator_tpu_torch.kernels.resolve import resolve
    from horizonator_tpu_torch.kernels.window_march import march
    from horizonator_tpu_torch.render import render_panorama
    from horizonator_tpu_torch.render.crossing import k_cross_for
    from horizonator_tpu_torch.render.mesh import (render_mesh,
                                                   render_mesh_tiled)
    from horizonator_tpu_torch.render.window import step_budget
    t0 = time.perf_counter()
    dem, p = config1_scene(dev)
    mkw = dict(width=C1_W, height=C1_H, cells_per_deg=CPD)
    torch.cuda.synchronize()
    tm = time.perf_counter()
    (_, rng_m, overflow), peak_mb = peak_run(
        lambda: render_mesh_tiled(dem, p, **mkw))
    mesh_s = time.perf_counter() - tm
    if overflow != 0:
        fail(f"31: render_mesh_tiled overflow {overflow}")
    fm, am = first_rows(rng_m.cpu().numpy())
    k = k_cross_for(C1_ZFAR, CPD, C1_LAT, n=C1_N)
    wkw = dict(nsteps=k, sampler="window", lat_hint_deg=C1_LAT, **mkw)
    march.launches = resolve.launches = 0
    _, rng_w = render_panorama(dem, p, **wkw)
    torch.cuda.synchronize()
    launches = {"window_march": march.launches, "resolve": resolve.launches}
    if min(launches.values()) < 1:
        fail(f"31: config 1's render skipped a kernel: {launches}")
    ks = step_budget_api(C1_ZFAR, 100.0)
    _, rng_s = render_panorama(dem, p, nsteps=ks, sampler="step",
                               surface="triangulated", **mkw)
    for name, r in (("window", rng_w), (f"step triangulated K {ks}", rng_s)):
        f, a = first_rows(r.cpu().numpy())
        d = np.abs(fm[am].astype(int) - f[am].astype(int))
        if not (am == a).all() or d.max() > 1 or np.median(d) != 0:
            fail(f"31: mesh vs {name}: columns {int((am != a).sum())} "
                 f"differ, first-row error max {d.max()}, median "
                 f"{np.median(d)}")
        log(f"[31] first visible row, mesh vs {name}: the same {int(am.sum())}"
            f" columns see terrain, error max {d.max()} px, median "
            f"{np.median(d):g}, mean {d.mean():.4f}")
    ms_w = cuda_ms(lambda i: render_panorama(dem, p, **wkw), RENDERS)
    ms_s = cuda_ms(lambda i: render_panorama(
        dem, p, nsteps=ks, sampler="step", surface="triangulated", **mkw),
        RENDERS)
    ms_m = cuda_ms(lambda i: render_mesh_tiled(dem, p, **mkw), 3)
    log(f"[31] config 1 ({C1_N}^2, {C1_W}x{C1_H}, -60..60 deg, zfar "
        f"{C1_ZFAR:g}): window render {ms_w:.3f} ms (median of {RENDERS}), "
        f"launches {launches}; step triangulated render {ms_s:.3f} ms; "
        f"render_mesh_tiled {ms_m:.1f} ms (median of 3; first call "
        f"{1e3 * mesh_s:.0f} ms, peak device memory {peak_mb:.0f} MB), "
        f"overflow 0; {card}")

    # the window march alone at config 1's shape
    from horizonator_tpu_torch.kernels.window_march import march_plain
    from horizonator_tpu_torch.render.crossing import crossing_geometry
    geo = crossing_geometry(p, width=C1_W, cells_per_deg=CPD)
    pcol, fscal = pcol_fscal(geo, p)
    k_lim = step_budget(k, C1_N)
    got, ref = march(dem, pcol, fscal, k_lim), march_plain(dem, pcol, fscal,
                                                           k_lim)
    if not torch.equal(got, ref):
        fail("31: window march != plain at config 1")
    m_ms = graph_ms(lambda: march(dem, pcol, fscal, k_lim), GRAPH_LAUNCHES)
    m_plain = cuda_ms_run(lambda i: march_plain(dem, pcol, fscal, k_lim), 5)
    cell_n = 6371000.0 * math.pi / 180.0 / CPD
    cells = reached_cells(C1_N, [600.3], [599.7], 0.0, C1_ZFAR, cell_n,
                          C1_LAT, [math.radians(-60.0)], [math.radians(60.0)])
    nbytes = 4 * cells + pcol.nbytes + fscal.nbytes + 4 * C1_W * k_lim
    b_ms, b_by = bound(nbytes, MARCH_FLOPS * C1_W * k_lim, FP32_OPS_PER_S)
    log(f"[31] config 1 window march ({C1_W}, {k_lim}) == plain bitwise; "
        f"device ms {m_ms:.4f} (plain {m_plain:.3f}), bound {b_ms:.5f} "
        f"({b_by}: {cells} DEM cells in the window's sector), share "
        f"{100 * b_ms / m_ms:.1f}%")
    record = dict(cell="config 1", k=k_lim, launches=launches["window_march"],
                  ms=m_ms, plain_ms=m_plain, bound_ms=b_ms, bound_by=b_by,
                  ms_per_frame=ms_w)

    # the tests' 192^2 scene: render_mesh on the card against the CPU
    from horizonator_tpu_torch.render import make_params
    rng_np = np.random.default_rng(3)
    n = 192
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (500.0 + 300.0 * np.sin(ii / 31.0) * np.cos(jj / 23.0)
         + 4.0 * rng_np.standard_normal((n, n), dtype=np.float32))
    small = np.maximum(z, 0.0).astype(np.float32)
    c = n // 2
    vz = float(small[c - 1:c + 1, c - 1:c + 1].max()) + 15.0
    outs = []
    for d in (dev, "cpu"):
        ps = make_params(device=d, viewer_cell_i=c + 0.3,
                         viewer_cell_j=c - 0.4, viewer_z=vz,
                         cos_viewer_lat=math.cos(math.radians(34.0)),
                         az_rad0=math.radians(-60.0),
                         az_rad1=math.radians(60.0), znear=800.0,
                         zfar=8000.0, znear_color=800.0, zfar_color=8000.0)
        outs.append([x.cpu().numpy() for x in render_mesh(
            torch.from_numpy(small).to(d), ps, width=256, height=128,
            cells_per_deg=CPD, max_bbox=32)])
    (ig, rg, og), (ic, rc_, oc) = outs
    both = (rg > 0) & (rc_ > 0)
    cover = float(((rg > 0) == (rc_ > 0)).mean())
    rel = float((np.abs(rg[both] - rc_[both]) / rc_[both]).max())
    img_px = float((ig != ic).any(axis=-1).mean())
    if int(og) != int(oc) or cover < 0.999 or rel > 1e-5 or img_px > 0.001:
        fail(f"31: render_mesh card vs CPU: overflow {og}/{oc}, coverage "
             f"{cover}, range error {rel}, image pixels {img_px}")
    log(f"[31] render_mesh 192^2 at 256x128 card vs CPU: overflow "
        f"{int(og)} both, coverage equal at {cover:.4%}, ranges within "
        f"{rel:.2e} relative (tolerance 1e-5), {img_px:.4%} image pixels "
        f"differ")
    log(f"[t] phase 31: {time.perf_counter() - t0:.1f} s")
    return record


def oracle_phases(dev, card, int32_rate):
    """Phases 29-31; {kernel name: the records of its launches on those
    paths}."""
    return {"resolve": step_phase(dev, card, int32_rate)
            + [crossing_phase(dev, card, int32_rate)],
            "window_march": [mesh_phase(dev, card, int32_rate)]}


def decode_png(data):
    """The pixels of an 8-bit RGB PNG, decoded with zlib alone (no PIL on
    the card's machine): every row must carry filter 0, as the port's
    writer puts it."""
    import struct
    import zlib
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"not a PNG: {data[:8]!r}")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] \
                != zlib.crc32(kind + body):
            fail(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        fail(f"PNG is not 8-bit RGB: {hdr}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        fail(f"PNG rows with filters {sorted(set(rows[:, 0].tolist()))}")
    return rows[:, 1:].reshape(h, w, 3)


class LoopbackFiles:
    """An HTTP server on 127.0.0.1 of ``payloads`` (path -> bytes) in a
    thread, counting its hits and their User-Agents; 404 elsewhere.
    ``headers`` (path -> [(name, value)]) adds response headers; a POST is
    answered with the bytes ``post`` (404 when None) and recorded in
    ``posts`` as (path, Content-Type, body)."""

    def __init__(self, payloads, headers=None, post=None):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.hits, self.agents, self.posts = [], [], []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def answer(self, body, extra=()):
                self.send_response(200 if body is not None else 404)
                for k, v in extra:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body or b"")))
                self.end_headers()
                self.wfile.write(body or b"")

            def do_GET(self):
                outer.hits.append(self.path)
                outer.agents.append(self.headers.get("User-Agent"))
                self.answer(payloads.get(self.path),
                            (headers or {}).get(self.path, ()))

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                outer.posts.append((self.path,
                                    self.headers.get("Content-Type"),
                                    self.rfile.read(n)))
                self.answer(post)

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


def http(url, path, body=None):
    """GET (or POST ``body`` as JSON) to a loopback server: (bytes, type)."""
    import urllib.request
    req = urllib.request.Request(
        url + path, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read(), r.headers.get("Content-Type")


def native_loads(card, tiles):
    """Phase 32, part 1: load_mosaic through the native loader (g++ on this
    machine, no fallback accepted) and through numpy, bitwise; ms of each."""
    from horizonator_tpu_torch import _native
    from horizonator_tpu_torch.dem import load_mosaic
    if _native.get_lib() is None:
        fail("the native DEM loader did not build (g++)")
    t0 = time.perf_counter()
    if not _native._build():                  # once more, to time g++
        fail("the native DEM loader did not rebuild (g++)")
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as s1:
        write_srtm1_tile(s1)
        cases = [("3x3 SRTM3 tiles, radius 1000 cells", 34.4, -117.6,
                  dict(render_radius_cells=1000, datadir=tiles)),
                 ("SRTM1 tile at 40 km", 34.5, -117.5,
                  dict(render_radius_m=40000.0, datadir=s1, srtm1=True,
                       warn_missing=False))]
        for name, lat, lon, kw in cases:
            grids, ms = {}, {}
            for path in ("native", "numpy"):
                if path == "numpy":
                    os.environ["HORIZONATOR_TPU_NO_NATIVE"] = "1"
                _native._tried, _native._lib = False, None
                try:
                    if (_native.get_lib() is None) != (path == "numpy"):
                        fail(f"the {path} path did not take effect")
                    times = []
                    for _ in range(5):
                        t1 = time.perf_counter()
                        grids[path] = load_mosaic(lat, lon, **kw).grid
                        times.append(1e3 * (time.perf_counter() - t1))
                    ms[path] = statistics.median(times)
                finally:
                    os.environ.pop("HORIZONATOR_TPU_NO_NATIVE", None)
                    _native._tried, _native._lib = False, None
            if not np.array_equal(grids["native"], grids["numpy"]):
                fail(f"native load != numpy load ({name})")
            log(f"[32] load_mosaic {name} {grids['native'].shape}: native "
                f"{ms['native']:.3f} ms, numpy {ms['numpy']:.3f} ms (median "
                f"of 5), {ms['numpy'] / ms['native']:.2f}x, grids bitwise "
                f"equal; {card}")
    log(f"[32] native loader: g++ builds it in {build_s:.2f} s; {card}")


def dem_download(dev, card, tiles, img6, rng6):
    """Phase 32, part 2: the API with allow_dem_downloads over a loopback
    server of phase 6's tiles (raw, gzip, zip, a multi-member zip) into an
    empty dir: files byte for byte, the render bitwise phase 6's, and a
    second construction fetches nothing."""
    import gzip
    import io
    import zipfile
    from horizonator_tpu_torch import horizonator
    from horizonator_tpu_torch.kernels.resolve import resolve
    from horizonator_tpu_torch.kernels.window_march import march

    def zipped(members):
        b = io.BytesIO()
        with zipfile.ZipFile(b, "w") as z:
            for k, v in members.items():
                z.writestr(k, v)
        return b.getvalue()

    names = sorted(f for f in os.listdir(tiles) if f.endswith(".hgt"))
    raw = {f: open(os.path.join(tiles, f), "rb").read() for f in names}
    payloads, kinds = {}, {}
    for i, f in enumerate(names):
        kind = ("raw", "gzip", "zip", "multi-member zip")[i % 4]
        kinds[kind] = kinds.get(kind, 0) + 1
        payloads[f"/dem/{f[:3]}/{f}"] = (
            raw[f] if kind == "raw" else gzip.compress(raw[f])
            if kind == "gzip" else zipped({f: raw[f]}) if kind == "zip"
            else zipped({f"r/{g}": raw[g] for g in names}))
    srv = LoopbackFiles(payloads)
    try:
        with tempfile.TemporaryDirectory() as empty:
            fmt = srv.url + "/dem/{ns}/{name}"
            t0 = time.perf_counter()
            h = horizonator(34.4, -117.6, W, H, dir_dems=empty, device=dev,
                            allow_dem_downloads=True, dem_url_fmt=fmt)
            build_s = time.perf_counter() - t0
            n_hits = len(srv.hits)
            if sorted(srv.hits) != sorted(payloads):
                fail(f"downloader fetched {sorted(srv.hits)}")
            for f in names:
                with open(os.path.join(empty, f), "rb") as fh:
                    if fh.read() != raw[f]:
                        fail(f"downloaded {f} differs from its source")
            march.launches = resolve.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, rng = h.render(-180, 180)
            render_ms = 1e3 * (time.perf_counter() - t0)
            if min(march.launches, resolve.launches) < 1:
                fail(f"downloaded-DEM render launches: march "
                     f"{march.launches}, resolve {resolve.launches}")
            if not (np.array_equal(img, img6) and np.array_equal(rng, rng6)):
                fail("render of downloaded tiles != phase 6's render")
            horizonator(34.4, -117.6, 64, 32, dir_dems=empty, device=dev,
                        allow_dem_downloads=True, dem_url_fmt=fmt)
            if len(srv.hits) != n_hits:
                fail("second construction fetched again")
    finally:
        srv.close()
    log(f"[32] DEM download: {len(names)} tiles ({kinds}) from 127.0.0.1 "
        f"into an empty dir, byte for byte; constructor {build_s:.3f} s with "
        f"the fetches; render {W}x{H} {render_ms:.3f} ms, bitwise phase 6's; "
        f"a second construction fetched nothing; {card}")


def viewer_in_process(dev, card, tiles):
    """Phase 32, part 3: ViewerState over phase 6's scene at the viewer's
    default 1200x400, served on 127.0.0.1: routes, frames bitwise the
    API's renders, the moves and their kernel launches, pick; ms a move."""
    import threading
    from http.server import ThreadingHTTPServer
    from horizonator_tpu_torch import horizonator, tiles as tiles_mod, viewer
    from horizonator_tpu_torch._png import encode_png
    from horizonator_tpu_torch.kernels.resolve import (resolve,
                                                       resolve_textured)
    from horizonator_tpu_torch.kernels.window_march import (march,
                                                            march_textured)
    kernels = {"window_march": march, "window_march_tex": march_textured,
               "resolve": resolve, "resolve_tex": resolve_textured}

    def reset():
        for fn in kernels.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in kernels.items()}

    h = horizonator(34.4, -117.6, 1200, 400, dir_dems=tiles, device=dev)
    map_tiles = tempfile.TemporaryDirectory()
    state = viewer.ViewerState(h, 0.0, 45.0, 100.0, 40000.0,
                               dir_tiles=map_tiles.name,
                               tiles_url_fmt="http://127.0.0.1:9/%d/%d/%d.png")
    state.render({})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), viewer.make_handler(state))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def frame_is_api_render(tag):
        """/pano.png decoded == the API's render of the state's view."""
        got = decode_png(http(url, "/pano.png")[0])
        want = h.render(state.az_center - state.az_radius,
                        state.az_center + state.az_radius,
                        return_range=False, znear=state.znear,
                        zfar=state.zfar, debug_fill=state.fill)
        if state.debug:
            want = state._overlay_horizon(want)
        if not np.array_equal(got, want[:, :, ::-1]):
            fail(f"viewer frame ({tag}) != the API's render, "
                 f"{int((got != want[:, :, ::-1]).any(-1).sum())} px")

    def move(tag, body, want_kernels):
        reset()
        s = json.loads(http(url, "/api/render", body)[0])
        c = counts()
        if any(c[k] < 1 for k in want_kernels):
            fail(f"viewer move {tag} launched {c}")
        frame_is_api_render(tag)
        log(f"[32] move {tag}: launches {c}, frame bitwise the API's; "
            f"{card}")
        return s

    try:
        page = http(url, "/")[0]
        if b'src="http' in page or b'href="http' in page \
                or b'src="/map.js"' not in page:
            fail("viewer page references a resource off this origin")
        js, ctype = http(url, "/map.js")
        if "javascript" not in ctype or b"tileLayer" not in js:
            fail(f"/map.js not served ({ctype})")
        s = json.loads(http(url, "/api/state")[0])
        if (s["width"], s["height"], s["az_radius"]) != (1200, 400, 45.0):
            fail(f"bad /api/state {s}")
        gray = decode_png(http(url, "/tiles/12/701/1635.png")[0])
        if gray.shape != (256, 256, 3) or (gray != 200).any():
            fail("offline map tile is not the gray placeholder")
        p = tiles_mod.tile_path(state.tiles_dir, state.tiles_name, 12, 7, 9)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(encode_png(np.full((256, 256, 3), 55, np.uint8)))
        if http(url, "/tiles/12/7/9.png")[0] != p.read_bytes():
            fail("seeded cache tile not served as it is")
        log(f"[32] viewer routes: / same-origin only, /map.js "
            f"{len(js)} B, /api/state, /tiles/ gray offline and the cache "
            f"tile as it is")
        frame_is_api_render("first")
        plain = ("window_march", "resolve")
        tex = ("window_march_tex", "resolve_tex")
        move("pan", {"az_center": 30.0}, plain)
        if move("zoom out", {"az_radius": 500.0}, plain)["az_radius"] != 179:
            fail("az_radius not clamped at 179")
        if move("zoom in", {"az_radius": 0.01}, plain)["az_radius"] != 1:
            fail("az_radius not clamped at 1")
        move("zoom back", {"az_radius": 45.0}, plain)
        s = move("resize", {"width": 4096, "height": 1024}, plain)
        if (s["width"], s["height"]) != (4096, 1024):
            fail(f"resize gave {s['width']}x{s['height']}")
        move("resize back", {"width": 1200, "height": 400}, plain)
        move("w overlay", {"debug": True}, plain)
        move("w off", {"debug": False}, plain)
        move("e wireframe", {"fill": "wireframe"}, tex)
        move("e point", {"fill": "point"}, tex)
        move("e off", {"fill": ""}, plain)
        s = move("re-centre", {"lat": 34.45, "lon": -117.55}, plain)
        if (s["lat"], s["lon"]) != (34.45, -117.55):
            fail(f"re-centre gave {s['lat']}, {s['lon']}")
        ranges = h._last_ranges()
        ys, xs = np.nonzero(ranges > 2000.0)
        y, x = int(ys[len(ys) // 2]), int(xs[len(xs) // 2])
        hit = json.loads(http(url, "/api/pick", {"x": (x + 0.5) / 1200,
                                                 "y": (y + 0.5) / 400})[0])
        want = h.pick(x, y)
        if not hit["hit"] or (hit["lat"], hit["lon"]) != want:
            fail(f"pick terrain {hit} != h.pick {want}")
        sky = json.loads(http(url, "/api/pick", {"x": 0.5, "y": 0.0})[0])
        if sky["hit"] or ranges[0, 600] > 0:
            fail(f"pick sky {sky}")
        log(f"[32] pick ({x}, {y}) at {ranges[y, x]:.1f} m -> {want}, == "
            f"h.pick; the top row is sky, no hit; {card}")

        # ms a move over 20 pans: POST -> frame, split into the render
        # (the API call, host copy included), the PNG encode and the rest
        # (HTTP, JSON, the handler thread)
        spent = {"render": 0.0, "encode": 0.0}

        def timed(key, fn):
            def run(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                spent[key] += 1e3 * (time.perf_counter() - t)
                return out
            return run

        h.render = timed("render", h.render)
        viewer.encode_png = timed("encode", encode_png)
        rows = []
        try:
            for i in range(20):
                spent["render"] = spent["encode"] = 0.0
                reset()
                t = time.perf_counter()
                http(url, "/api/render", {"az_center": 30.0 + 7.0 * (i + 1)})
                png = http(url, "/pano.png")[0]
                total = 1e3 * (time.perf_counter() - t)
                rows.append((total, spent["render"], spent["encode"],
                             sum(counts().values()), len(png)))
        finally:
            del h.render
            viewer.encode_png = encode_png
        tot, ren, enc, nk, nb = (statistics.median(c) for c in zip(*rows))
        log(f"[32] viewer move 1200x400 (median of 20 pans, POST to PNG): "
            f"{tot:.3f} ms = render {ren:.3f} + PNG encode {enc:.3f} + HTTP "
            f"and the rest {tot - ren - enc:.3f}; kernel launches a move "
            f"{nk:g}; PNG {nb / 1e3:.1f} kB; {card}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
        map_tiles.cleanup()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def viewer_entry_points(dev, card, tiles):
    """Phase 32, part 4: the viewer's own main in a subprocess on a free
    port, the CLI's interactive mode in-process (viewer.serve stood in),
    and the CLI's --image .png through the port's PNG writer."""
    import urllib.error
    from horizonator_tpu_torch import cli, horizonator, viewer
    from horizonator_tpu_torch.kernels.resolve import resolve
    from horizonator_tpu_torch.kernels.window_march import march
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    err = tempfile.TemporaryFile()
    proc = subprocess.Popen(
        [sys.executable, "-m", "horizonator_tpu_torch.viewer", "34.4",
         "-117.6", "0", "45", "--dirdems", tiles, "--port", str(port)],
        stdout=subprocess.DEVNULL, stderr=err)
    try:
        while True:
            if proc.poll() is not None:
                err.seek(0)
                fail(f"viewer exited {proc.returncode}: "
                     f"{err.read().decode()[-2000:]}")
            if time.perf_counter() - t0 > 120:
                fail("viewer did not answer /api/state within 120 s")
            try:
                s = json.loads(http(url, "/api/state")[0])
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.25)
        up_s = time.perf_counter() - t0
        s = json.loads(http(url, "/api/render", {"az_center": 90.0})[0])
        frame = decode_png(http(url, "/pano.png")[0])
        if s["az_center"] != 90.0 or frame.shape != (400, 1200, 3):
            fail(f"viewer subprocess: state {s}, frame {frame.shape}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        err.close()
    log(f"[32] python -m horizonator_tpu_torch.viewer: /api/state after "
        f"{up_s:.1f} s, one move, a {frame.shape[1]}x{frame.shape[0]} frame; "
        f"terminated; {card}")

    seen = []

    def stand_in(state, port=8080, **kw):
        march.launches = resolve.launches = 0
        seen.append((state, port, state.render({"az_center": 20.0}),
                     march.launches, resolve.launches))

    real_serve = viewer.serve
    viewer.serve = stand_in
    try:
        rc = cli.main(["--dirdems", tiles, "34.4", "-117.6", "0", "45"])
    finally:
        viewer.serve = real_serve
    if rc != 0 or len(seen) != 1:
        fail(f"CLI interactive mode rc {rc}, served {len(seen)}")
    state, port, s, n_march, n_resolve = seen[0]
    if state.h.device.type != "cuda" or min(n_march, n_resolve) < 1 \
            or port != 8080 or s["az_center"] != 20.0:
        fail(f"CLI interactive mode: device {state.h.device}, port {port}, "
             f"launches {n_march} / {n_resolve}")
    log(f"[32] CLI interactive mode: viewer on {state.h.device}, port "
        f"{port}, one move launched march {n_march} / resolve {n_resolve}; "
        f"{card}")

    with tempfile.TemporaryDirectory() as td:
        png = os.path.join(td, "pano.png")
        t0 = time.perf_counter()
        rc = cli.main(["--width", str(W), "--height", str(H), "--image", png,
                       "--dirdems", tiles, "34.4", "-117.6", "0", "180"])
        cli_s = time.perf_counter() - t0
        with open(png, "rb") as f:
            data = f.read()
    img = horizonator(34.4, -117.6, W, H, dir_dems=tiles,
                      render_radius_m=40000.0).render(-180, 180)[0]
    if rc != 0 or not np.array_equal(decode_png(data), img[:, :, ::-1]):
        fail("CLI --image .png != the API's image")
    log(f"[32] CLI {W}x{H} -> .png ({len(data) / 1e6:.2f} MB) in "
        f"{cli_s:.2f} s, decoded bitwise the API's image; {card}")


def front_phase(dev, card, tiles, img6=None, rng6=None):
    """Phase 32: the host front ends on the card, over phase 6's tiles
    (``img6``, ``rng6``: phase 6's render of them, made here when None)."""
    from horizonator_tpu_torch import horizonator
    t0 = time.perf_counter()
    if img6 is None:
        img6, rng6 = horizonator(34.4, -117.6, W, H, dir_dems=tiles,
                                 device=dev).render(-180, 180)
    native_loads(card, tiles)
    dem_download(dev, card, tiles, img6, rng6)
    viewer_in_process(dev, card, tiles)
    viewer_entry_points(dev, card, tiles)
    log(f"[t] phase 32: {time.perf_counter() - t0:.1f} s")


SCALE_R = 4                   # phase 33: row bands of the bench grid
SCALE_BATCH = 8               # phase 33: render_batch(mesh="auto") viewpoints
API_RUNS = 11                 # phase 33: region and plain API renders timed
WEDGE_OFF = 4                 # phase 33: wedged pixels past 5e-3 + 1 m
BAND_FRAMES = 3               # phase 33: region renders profiled
TILE_SEED = 33                # phases 33-34: the seeded map tiles
PHASE_RENDERS = 5             # phase 34: renders under the PhaseTimer
CHAIN_REPS = 16               # phase 34: camera moves a timed chain
DECODES, PLAIN_DECODES = 20, 3  # phase 34: timed decodes of a tile


def interleaved_ms(fa, fb, n):
    """Median ms of fa(i) and of fb(i), n calls each in turns (a, b, a,
    b, ...) after one of each, CUDA events around each call."""
    fa(0)
    fb(0)
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(n):
        for f, t in zip((fa, fb), times):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            f(i)
            t1.record()
            t1.synchronize()
            t.append(t0.elapsed_time(t1))
    return statistics.median(times[0]), statistics.median(times[1])


def profile_gap(fa, fb, n=5, top=6):
    """Where a call of fa() spends host time that fb() does not:
    torch.profiler over n calls of each, in the order a, b, b, a (so
    neither pays alone for what comes first). Returns per call the host ops
    (a, b), their self CPU ms (a, b), the device busy ms (a, b), and the
    ``top`` ops by extra self CPU ms and by extra device ms: (name, calls
    a, calls b, ms)."""
    from torch.profiler import ProfilerActivity, profile as tprof
    per = ({}, {})
    for which in (0, 1, 1, 0):
        f = (fa, fb)[which]
        f()
        torch.cuda.synchronize()
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                f()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            v = (e.count / n / 2, e.self_cpu_time_total / n / 2e3,
                 e.self_device_time_total / n / 2e3)
            per[which][e.key] = tuple(x + y for x, y in zip(
                per[which].get(e.key, (0, 0, 0)), v))
    a, b = per
    none = (0, 0, 0)

    def extra(c):
        return sorted(((k, a.get(k, none)[0], b.get(k, none)[0],
                        a.get(k, none)[c] - b.get(k, none)[c])
                       for k in set(a) | set(b)), key=lambda x: -x[3])[:top]
    return {"ops": tuple(sum(v[0] for v in d.values()) for d in per),
            "cpu_ms": tuple(sum(v[1] for v in d.values()) for d in per),
            "dev_ms": tuple(sum(v[2] for v in d.values()) for d in per),
            "top": extra(1), "top_dev": extra(2)}


def band_edge_cases():
    """(name, n, viewer i, j, az0, az1 deg, W, K, znear, zfar, bands, what):
    the band shapes on which the banded entries' tile vote can go wrong, on
    an (n, n) grid of which ``bands`` are marched: ("R", r) is r bands of
    ceil(n / r) rows + halo over the grid zero-padded to r bands (the API's
    padding, masked through band_bounds' n_valid), else a list of (j_off,
    nj, j_hi) bands cut from the grid zero-padded as far as they reach.
    ``what`` must hold of the case: "split" (a tile live in two bands),
    "empty" (a band with no valid sample), "row" (valid samples on the
    band's one row alone), "one" (exactly one valid sample), "inside" /
    "first" / "last" / "north" / "south" (where the viewer's row lies
    against the band), "j_dom" / "i_dom" (every column row- or column-
    dominant). tests/test_torch_window.py holds the plain version to the
    JAX march at the same cases."""
    a360 = (-180.0, 180.0)
    band = [(40, 41, 40.0)]
    return [
        ("R 3 on 100 rows (34-row bands)", 100, 50.2, 49.7, *a360, 37, 129,
         100.0, 8000.0, ("R", 3), "split"),
        ("R 8 on 100 rows (13-row bands)", 100, 50.2, 49.7, *a360, 61, 129,
         100.0, 8000.0, ("R", 8), "split"),
        ("bands beyond zfar", 160, 80.3, 20.6, *a360, 64, 128, 100.0, 3000.0,
         ("R", 4), "empty"),
        ("padding alone (j_hi < 0)", 100, 50.2, 49.7, *a360, 40, 132, 100.0,
         8000.0, [(40, 21, -1.0), (94, 8, -1.0)], "empty"),
        ("one valid row (j_hi 0)", 100, 50.2, 49.7, *a360, 64, 129, 100.0,
         8000.0, [(45, 2, 0.0), (57, 2, 0.0)], "row"),
        ("one valid sample", 100, 50.2, 49.7, 10.0, 11.0, 1, 129, 100.0,
         8000.0, [(60, 2, 0.0)], "one"),
        ("viewer inside the band", 120, 60.3, 60.4, *a360, 40, 132, 100.0,
         8000.0, band, "inside"),
        ("viewer on the band's first row", 120, 60.3, 40.0, *a360, 40, 129,
         100.0, 8000.0, band, "first"),
        ("viewer on the band's last row", 120, 60.3, 80.0, *a360, 40, 129,
         100.0, 8000.0, band, "last"),
        ("viewer north of the band", 120, 60.3, 101.7, *a360, 40, 129,
         100.0, 8000.0, band, "north"),
        ("viewer south of the band", 120, 60.3, 15.2, *a360, 40, 129, 100.0,
         8000.0, band, "south"),
        ("all row-dominant", 100, 50.2, 49.7, -10.0, 10.0, 64, 65, 100.0,
         8000.0, ("R", 4), "j_dom"),
        ("all column-dominant", 100, 50.2, 49.7, 80.0, 100.0, 64, 65, 100.0,
         8000.0, ("R", 4), "i_dom"),
    ]


def edge_bands(n, bands):
    """[(j_off, nj, j_hi)] of a case's bands and the rows that the padded
    grid must have."""
    if bands[0] == "R":
        from horizonator_tpu_torch.parallel.regions import band_bounds
        r = bands[1]
        nb = -(-n // r)
        bands = [(j_off, nb + 1, j_hi) for j_off, j_hi in (
            band_bounds(i, r, nb, n) for i in range(r))]
    return bands, max(n, max(j + nj for j, nj, _ in bands))


def tile_map(valid):
    """Which tiles of the march kernel (32 columns x 64 steps) hold a valid
    sample, of a (..., W, K) validity mask."""
    *b, w, k = valid.shape
    v = torch.nn.functional.pad(valid, (0, -k % 64, 0, -w % 32))
    v = v.reshape(*b, v.shape[-2] // 32, 32, v.shape[-1] // 64, 64)
    return v.any(-1).any(-2)


def live_tiles(valid):
    """(live tiles, all tiles) of a (..., W, K) validity mask."""
    t = tile_map(valid)
    return int(t.sum()), t.numel()


def band_edge_case_shows(what, valids, bands, jd, vj):
    """Whether a case shows its edge: ``valids`` the bands' (W, K) masks."""
    j_off, _, j_hi = bands[0]
    if what == "split":
        t = torch.stack([tile_map(v) for v in valids])
        return bool((t.sum(0) >= 2).any()) and all(v.any() for v in valids)
    if what == "empty":
        return any(not v.any() for v in valids)
    if what == "row":
        return all(v.any() for v in valids)
    if what == "one":
        return int(valids[0].sum()) == 1
    side = {"inside": j_off < vj < j_off + j_hi, "first": vj == j_off,
            "last": vj == j_off + j_hi, "north": vj > j_off + j_hi,
            "south": vj < j_off}
    if what in side:
        return side[what] and bool(valids[0].any())
    if what == "j_dom":
        return bool(jd.all())
    return bool((~jd).all())


def band_edge_phase(dev):
    """Phase 33's edge shapes: both banded entries (textured at s = 1 and
    s = 2) against their plain version at band_edge_cases(), bitwise, the
    bands' MAX against the square march where the bands cover the grid,
    and a batch of 3 viewpoints with a (3, nj, ni) band each against the
    batched plain version and each viewpoint's unbatched launch. Returns
    the log line."""
    from horizonator_tpu_torch.kernels.window_march import (
        march, march_band, march_band_textured, march_plain)
    from horizonator_tpu_torch.render import make_params
    from horizonator_tpu_torch.render.crossing import crossing_geometry
    rng = np.random.default_rng(33)
    names = []
    for name, n, vi, vj, az0, az1, w, k, znear, zfar, spec, what in \
            band_edge_cases():
        bands, rows = edge_bands(n, spec)
        dem = torch.from_numpy((2000.0 * rng.random((n, n))).astype(
            np.float32)).to(dev)
        grid = torch.nn.functional.pad(dem, (0, 0, 0, rows - n))
        planes = {s: torch.from_numpy(rng.integers(
            0, 1 << 24, (s * rows, s * n), dtype=np.int32)).to(dev)
            for s in (1, 2)}
        p = make_params(device=dev, viewer_cell_i=vi, viewer_cell_j=vj,
                        viewer_z=900.0,
                        cos_viewer_lat=math.cos(math.radians(LAT)),
                        az_rad0=math.radians(az0), az_rad1=math.radians(az1),
                        znear=znear, zfar=zfar, znear_color=znear,
                        zfar_color=zfar, curv=6.8e-8)
        pcol, fscal = pcol_fscal(crossing_geometry(p, width=w,
                                                   cells_per_deg=CPD), p)
        valids, parts, live = [], [], []
        for j_off, nj, j_hi in bands:
            loc = grid[j_off:j_off + nj].contiguous()
            ref = march_plain(loc, pcol, fscal, k, j_offset=j_off, j_hi=j_hi)
            got = march_band(loc, pcol, fscal, k, j_off, j_hi)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"banded march != plain at edge case '{name}', band "
                     f"{j_off}+{nj} (j_hi {j_hi}): "
                     f"{int((got != ref).sum())} samples differ")
            valid = ref > -1e30
            for s, plane in planes.items():
                loc_c = plane[s * j_off:s * (j_off + nj)].contiguous()
                ref_t, ref_c = march_plain(loc, pcol, fscal, k, loc_c, s,
                                           j_offset=j_off, j_hi=j_hi)
                got_t, got_c = march_band_textured(loc, pcol, fscal, k, loc_c,
                                                   s, j_off, j_hi)
                torch.cuda.synchronize()
                if not (torch.equal(got_t, ref) and torch.equal(ref_t, ref)
                        and torch.equal(got_c, ref_c)):
                    fail(f"banded textured march (s {s}) != plain at edge "
                         f"case '{name}', band {j_off}+{nj}: "
                         f"{int((got_c != ref_c).sum())} colors differ")
                if (got_c[~valid] != 0).any():
                    fail(f"banded textured march (s {s}) colors an invalid "
                         f"sample at edge case '{name}'")
            valids.append(valid)
            parts.append(got)
            live.append(live_tiles(valid)[0])
        if not band_edge_case_shows(what, valids, bands, pcol[:, 6] != 0.0,
                                    vj):
            fail(f"band edge case '{name}' does not show its edge")
        if spec[0] == "R":
            sq = march(dem, pcol, fscal, k)
            torch.cuda.synchronize()
            if not torch.equal(torch.stack(parts).amax(0), sq):
                fail(f"bands' MAX != square march at edge case '{name}'")
        names.append(f"{name} ({w}, {k}): live tiles {live} of "
                     f"{live_tiles(valids[0])[1]}, valid "
                     f"{[int(v.sum()) for v in valids]}")
    # a batch of 3 viewpoints, a band of its own grid each
    b, n, w, k, (j_off, nj, j_hi) = 3, 100, 37, 129, (30, 31, 30.0)
    i = np.arange(b)
    p = batch_params(dev, 40.3 + 9.1 * i, 28.6 + 21.3 * i, 700.0 + 37.0 * i,
                     LAT, -180.0 + 23.0 * i, 150.0 - 31.0 * i,
                     [10.0, 100.0, 1000.0], [8000.0, 2500.0, 20000.0],
                     [0.0, 6.8e-8, 6.8e-8])
    pcol, fscal = pcol_fscal(crossing_geometry(p, width=w,
                                               cells_per_deg=CPD), p)
    loc = torch.from_numpy((2000.0 * rng.random((b, nj, n))).astype(
        np.float32)).to(dev)
    ref = march_plain(loc, pcol, fscal, k, j_offset=j_off, j_hi=j_hi)
    got = march_band(loc, pcol, fscal, k, j_off, j_hi)
    torch.cuda.synchronize()
    valid = ref > -1e30
    if got.shape != (b, w, k) or not torch.equal(got, ref):
        fail("batched banded march (B 3, a band each) != plain")
    if not all(bool(valid[v].any()) for v in range(b)):
        fail("batched banded march: a viewpoint has no valid sample")
    for s in (1, 2):
        colors = torch.from_numpy(rng.integers(
            0, 1 << 24, (b, s * nj, s * n), dtype=np.int32)).to(dev)
        ref_t, ref_c = march_plain(loc, pcol, fscal, k, colors, s,
                                   j_offset=j_off, j_hi=j_hi)
        got_t, got_c = march_band_textured(loc, pcol, fscal, k, colors, s,
                                           j_off, j_hi)
        torch.cuda.synchronize()
        if not (torch.equal(got_t, ref) and torch.equal(ref_t, ref)
                and torch.equal(got_c, ref_c)):
            fail(f"batched banded textured march (B 3, s {s}) != plain")
        for v in range(b):
            one = march_band_textured(loc[v], pcol[v], fscal[v], k,
                                      colors[v], s, j_off, j_hi)
            if not (torch.equal(one[0], got[v])
                    and torch.equal(one[1], got_c[v])):
                fail(f"batched banded textured march (s {s}) viewpoint {v} "
                     f"!= its unbatched launch")
    for v in range(b):
        if not torch.equal(march_band(loc[v], pcol[v], fscal[v], k, j_off,
                                      j_hi), got[v]):
            fail(f"batched banded march viewpoint {v} != its unbatched "
                 f"launch")
    names.append(f"B 3, a ({nj}, {n}) band each ({w}, {k}): live tiles "
                 f"{live_tiles(valid)[0]} of {live_tiles(valid)[1]}")
    return ("both banded entries (textured at s = 1 and 2) == plain "
            "bitwise (samples incl. NEG_BIG, colors incl. 0 at invalid "
            "samples) at the band edge shapes: " + "; ".join(names))


def band_in_frame(drive, r):
    """{textured: [each band's mean device ms]}: torch.profiler over
    BAND_FRAMES region renders of ``r`` bands (phase 33's ``drive``), each
    band kernel launch's device time, taken in launch order (band 0 to r -
    1 in each render)."""
    from torch.profiler import ProfilerActivity, profile as tprof
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for tex, name in ((False, "window_march_band_kernel"),
                      (True, "window_march_band_tex_kernel")):
        drive({"region": r}, tex)
        torch.cuda.synchronize()
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(BAND_FRAMES):
                drive({"region": r}, tex)
            torch.cuda.synchronize()
        ms = [us / 1e3 for _, us in sorted(
            (e.time_range.start, e.self_device_time_total)
            for e in prof.events() if e.device_type == cuda
            and name in e.name)]
        if len(ms) != BAND_FRAMES * r:
            fail(f"profile of the region render: {len(ms)} launches of "
                 f"{name}, want {BAND_FRAMES * r}")
        out[tex] = [statistics.mean(ms[i::r]) for i in range(r)]
    return out


def png_file(rgb=None, index=None, palette=None, filters=(0, 1, 2, 3, 4)):
    """The bytes of a PNG of the script's own writer (the port's encode_png
    writes RGB with filter 0 alone), in the forms map tile servers send:
    8-bit RGB ``rgb`` (H, W, 3) whose row r takes filter
    ``filters[r % len(filters)]``, or an 8-bit palette image (``index``
    (H, W), ``palette`` (256, 3)) with filter 0 on every row."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    if rgb is None:
        h, w = index.shape
        rows = np.hstack([np.zeros((h, 1), np.uint8), index])
        ctype, plte = 3, chunk(b"PLTE", palette.tobytes())
    else:
        h, w, _ = rgb.shape
        cur = rgb.reshape(h, 3 * w).astype(np.int32)
        up = np.vstack([np.zeros((1, 3 * w), np.int32), cur[:-1]])
        left = np.hstack([np.zeros((h, 3), np.int32), cur[:, :-3]])
        ul = np.hstack([np.zeros((h, 3), np.int32), up[:, :-3]])
        est = left + up - ul
        pa, pb, pc = abs(est - left), abs(est - up), abs(est - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = np.stack([np.zeros_like(cur), left, up, (left + up) // 2,
                         paeth])
        f = np.asarray(filters)[np.arange(h) % len(filters)]
        rows = np.hstack([f[:, None], (cur - pred[f, np.arange(h)]) & 255])
        ctype, plte = 2, b""
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + plte + chunk(b"IDAT", zlib.compress(rows.astype(
                np.uint8).tobytes(), 6)) + chunk(b"IEND", b""))


def tile_pixels(x, y):
    """Map tile (x, y)'s seeded RGB pixels and its file: tiles with x + y
    even as 8-bit RGB rows filtered 0-4 in turn, the others as a
    256-colour palette image."""
    rng = np.random.default_rng((TILE_SEED, x, y))
    yy, xx = np.mgrid[0:256, 0:256]
    h = int(rng.integers(0, 251))
    if (x + y) % 2 == 0:
        rgb = np.stack([(xx + h) % 256, (yy * 3 + h) % 256,
                        (xx + yy + 7 * h) % 256], -1).astype(np.uint8)
        return rgb, png_file(rgb)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    index = ((xx // 4 + 5 * (yy // 8) + h) % 256).astype(np.uint8)
    return palette[index], png_file(index=index, palette=palette)


def atlas_tiles(h):
    """The z12 tiles (xs, ys) of the API object ``h``'s texture atlas:
    tiles.build_atlas's range for its viewer and radius."""
    from horizonator_tpu_torch.render.texture import tile_xy_from_latlon
    d = h.mosaic.radius_cells / h.mosaic.cells_per_deg
    x0, y0 = tile_xy_from_latlon(h.viewer_lat + d, h.viewer_lon - d, 12)
    x1, y1 = tile_xy_from_latlon(h.viewer_lat - d, h.viewer_lon + d, 12)
    return range(x0, x1 + 1), range(y0, y1 + 1)


def seeded_tiles(xs, ys):
    """tile_pixels over xs x ys: ({url path /12/x/y.png: file bytes}, the
    BGR atlas of their pixels, rows from the north)."""
    files = {}
    atlas = np.zeros((256 * len(ys), 256 * len(xs), 3), np.uint8)
    for j, y in enumerate(ys):
        for i, x in enumerate(xs):
            rgb, files[f"/12/{x}/{y}.png"] = tile_pixels(x, y)
            atlas[256 * j:256 * (j + 1), 256 * i:256 * (i + 1)] = \
                rgb[:, :, ::-1]
    return files, atlas


def write_tile_cache(root, files):
    """seeded_tiles' files as a mapnik tile cache under ``root``."""
    for path, data in files.items():
        dst = os.path.join(root, "mapnik", *path.strip("/").split("/"))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(data)


def scale_out_phase(dev, card, tiles):
    """Phase 33: scale-out on one card. The banded march entries on the
    SCALE_R row bands of phase 2's scene against their plain version and
    their MAX against the square march; the region renderer's per-rank
    local functions for every rank of SCALE_R bands (and of 2 bands x 2
    wedges), combined as the collectives combine them, against the
    single-device render, untextured and textured (phase 9's half-cell
    planes, atlas and hybrid near field); then through a one-rank NCCL
    group: the API's region_mesh="auto" (untextured, and textured hybrid
    from a cache of seeded PNG tiles through the port's decoder, its atlas
    the tiles' pixels), render_batch(mesh="auto") of SCALE_BATCH
    viewpoints and viewshed_count(mesh="auto") at config 10's shape.
    Returns the banded entries' JSON records."""
    import torch.distributed as dist
    from horizonator_tpu_torch import horizonator
    from horizonator_tpu_torch.kernels.resolve import (resolve,
                                                       resolve_textured)
    from horizonator_tpu_torch.kernels.window_march import (
        march, march_band, march_band_textured, march_plain, march_textured)
    from horizonator_tpu_torch.ops import viewshed_count
    from horizonator_tpu_torch.parallel.regions import (
        band_bounds, local_band, make_region_sharded_renderer)
    from horizonator_tpu_torch.render import make_params, render_panorama
    from horizonator_tpu_torch.render.crossing import (crossing_geometry,
                                                       k_cross_for)
    from horizonator_tpu_torch.render.texture import (AtlasParams,
                                                      pack_atlas,
                                                      pack_cell_colors,
                                                      prepare_color_planes,
                                                      tile_xy_from_latlon)
    from horizonator_tpu_torch.render.window import step_budget
    t0 = time.perf_counter()
    log(f"[33] {band_edge_phase(dev)}")
    r, nb = SCALE_R, N // SCALE_R
    dem = torch.from_numpy(bench_dem()).to(dev)
    p = make_params(device=dev, viewer_cell_i=N / 2, viewer_cell_j=N / 2,
                    viewer_z=900.0, cos_viewer_lat=math.cos(math.radians(
                        LAT)), az_rad0=-math.pi, az_rad1=math.pi,
                    znear=100.0, zfar=ZFAR, znear_color=100.0,
                    zfar_color=ZFAR)
    geo = crossing_geometry(p, width=W, cells_per_deg=CPD)
    pcol, fscal = pcol_fscal(geo, p)
    k = k_cross_for(ZFAR, CPD, LAT, n=N)
    k_lim = step_budget(k, N)
    # phase 9's half-cell planes and atlas
    cp2 = prepare_color_planes(torch.from_numpy(np.random.default_rng(
        3).integers(0, 256, (3, 2 * N, 2 * N), dtype=np.uint8)).to(
            dev).float())
    o_lon = LON - float(p.viewer_cell_i) / CPD
    o_lat = LAT - float(p.viewer_cell_j) / CPD
    tx0, ty0 = tile_xy_from_latlon(LAT, LON, 12)
    ap = AtlasParams(o_lon, o_lat, tx0 - 4, ty0 - 4, 8, 8)
    atlas = torch.from_numpy(np.random.default_rng(4).integers(
        0, 1 << 24, (2048, 2048), dtype=np.int32)).to(dev)
    plane = cp2.full_packed
    # a cell-resolution packed plane, for the textured entries at s = 1
    plane1 = pack_cell_colors(torch.from_numpy(np.random.default_rng(
        6).integers(0, 256, (3, N, N), dtype=np.uint8)).to(dev).float())

    # 1-2. each band's banded march (both entries; textured at s = 2 and
    # s = 1) against its plain version, their MAX against the square march
    sq = march(dem, pcol, fscal, k_lim)
    sq_t, sq_x = march_textured(dem, pcol, fscal, k_lim, plane, 2)
    sq_t1, sq_x1 = march_textured(dem, pcol, fscal, k_lim, plane1, 1)
    cell_n = 6371000.0 * math.pi / 180.0 / CPD
    bands, parts, parts_x, parts_x1 = [], [], [], []
    for idx in range(r):
        j_off, j_hi = band_bounds(idx, r, nb)
        loc = local_band(dem, idx, r)
        loc_c = local_band(cp2, idx, r).full_packed
        loc_1 = local_band(plane1, idx, r)
        t_k = march_band(loc, pcol, fscal, k_lim, j_off, j_hi)
        t_p = march_plain(loc, pcol, fscal, k_lim, j_offset=j_off,
                          j_hi=j_hi)
        tt_k, tx_k = march_band_textured(loc, pcol, fscal, k_lim, loc_c, 2,
                                         j_off, j_hi)
        tt_p, tx_p = march_plain(loc, pcol, fscal, k_lim, loc_c, 2,
                                 j_offset=j_off, j_hi=j_hi)
        t1_k, x1_k = march_band_textured(loc, pcol, fscal, k_lim, loc_1, 1,
                                         j_off, j_hi)
        t1_p, x1_p = march_plain(loc, pcol, fscal, k_lim, loc_1, 1,
                                 j_offset=j_off, j_hi=j_hi)
        torch.cuda.synchronize()
        if not (torch.equal(t_k, t_p) and torch.equal(tt_k, tt_p)
                and torch.equal(tx_k, tx_p) and torch.equal(tt_k, t_k)):
            fail(f"band {idx}: banded march != plain: "
                 f"{int((t_k != t_p).sum())} tangents, "
                 f"{int((tx_k != tx_p).sum())} colors differ")
        if not (torch.equal(t1_k, t1_p) and torch.equal(x1_k, x1_p)
                and torch.equal(t1_k, t_k)):
            fail(f"band {idx}: banded textured march at s = 1 != plain: "
                 f"{int((t1_k != t1_p).sum())} tangents, "
                 f"{int((x1_k != x1_p).sum())} colors differ")
        # (bands past zfar of the viewer have none)
        valid = int((t_k > -1e30).sum())
        parts.append(t_k)
        parts_x.append(torch.where(t_k > -1e30, tx_k, -1))
        parts_x1.append(torch.where(t_k > -1e30, x1_k, -1))
        cells = annulus_cells(N, N / 2, N / 2, 0.0, ZFAR, cell_n, LAT,
                              slice(j_off, j_off + nb + 1))
        live, n_tiles = live_tiles(t_p > -1e30)
        bands.append(dict(band=idx, rows=(j_off, j_off + nb), j_hi=j_hi,
                          valid=valid, cells=cells, live_tiles=live,
                          tiles=n_tiles))
    if sum(b["valid"] > 0 for b in bands) < 2:
        fail(f"fewer than two bands marched a valid sample: {bands}")
    comb = torch.stack(parts).amax(0)
    comb_x = torch.stack(parts_x).amax(0)
    comb_x1 = torch.stack(parts_x1).amax(0)
    ok = sq > -1e30
    if not torch.equal(comb, sq):
        fail(f"bands' MAX != square march: {int((comb != sq).sum())} differ")
    if not (torch.equal(sq_t, sq) and torch.equal(comb_x[ok], sq_x[ok])):
        fail("bands' masked color MAX != square textured march (s = 2)")
    if not (torch.equal(sq_t1, sq) and torch.equal(comb_x1[ok], sq_x1[ok])):
        fail("bands' masked color MAX != square textured march (s = 1)")
    log(f"[33] {r} bands of {nb} rows + halo of the {N}^2 grid at "
        f"({W}, {k_lim}): both banded entries (textured at s = 2 and 1) == "
        f"plain bitwise in every band; MAX of the bands == square march "
        f"bitwise, masked color MAX == square textured march (s = 2 and 1) "
        f"at its {int(ok.sum())} valid samples; valid samples a band "
        + ", ".join(str(b["valid"]) for b in bands) + "; live tiles (32 "
        "columns x 64 steps) a band " + ", ".join(
            f"{b['live_tiles']} of {b['tiles']}" for b in bands))

    # 3. the region renderer's per-rank local functions, every rank
    rkw = dict(width=W, height=H, k_cross=k, cells_per_deg=CPD,
               lat_hint_deg=LAT)
    hyb = dict(atlas_params=ap, exact_near_m=EXACT_NEAR_M)
    single = render_panorama(dem, p, nsteps=k, **{
        kk: v for kk, v in rkw.items() if kk != "k_cross"})
    single_t = render_panorama(dem, p, nsteps=k, textured=True,
                               color_planes=cp2, atlas=atlas, **hyb, **{
                                   kk: v for kk, v in rkw.items()
                                   if kk != "k_cross"})

    def drive(shape, textured):
        fn = make_region_sharded_renderer(
            shape, textured=textured, texture_scale=2,
            az_axis="az" if "az" in shape else None, **rkw,
            **(hyb if textured else {}))
        rr, wedges = shape["region"], []
        for a in range(shape.get("az", 1)):
            bms = [fn.local(i, a, local_band(dem, i, rr), p,
                            local_band(cp2, i, rr) if textured else None,
                            atlas if textured else None)
                   for i in range(rr)]
            wedges.append(fn.resolve(*fn.combine(bms), bms[0]))
        return tuple(torch.cat(xs, dim=1) for xs in zip(*wedges))

    launches = {}
    for textured, ref in ((False, single), (True, single_t)):
        march_band.launches = march_band_textured.launches = 0
        resolve.launches = resolve_textured.launches = 0
        img, rng = drive({"region": r}, textured)
        torch.cuda.synchronize()
        name = "window_march_band" + ("_textured" if textured else "")
        res_name = "resolve_textured" if textured else "resolve"
        launches[name] = (march_band_textured if textured
                          else march_band).launches
        res_launches = (resolve_textured if textured else resolve).launches
        if launches[name] != r or res_launches != 1:
            fail(f"region render launches: {name} {launches[name]}, "
                 f"{res_name} {res_launches}")
        if not (torch.equal(img, ref[0]) and torch.equal(rng, ref[1])):
            fail(f"region render ({name}) != single render: "
                 f"{int((rng != ref[1]).sum())} ranges differ")
        img_w, rng_w = drive({"region": 2, "az": 2}, textured)
        r1, rs = ref[1].cpu().numpy(), rng_w.cpu().numpy()
        # the wedge tolerance of tests/test_torch_regions.py (the JAX
        # tests', tests/test_regions.py:146-152): under 0.2% of the pixels
        # flip between sky and terrain, and the pixels that both renders
        # agree on are within 5e-3 relative + 1 m. At this size a wedge's
        # own float32 azimuths also move the first crossing of a ray that
        # grazes far terrain by a few samples, as they flip sky: at most
        # WEDGE_OFF such pixels (a wrong column at a seam is some 1000),
        # each with its range inside the span of its 3x3 neighbourhood's
        # terrain ranges in the single render
        def tol(v):
            return 1.0 + 5e-3 * np.abs(v)

        agree = (rs > 0) == (r1 > 0)
        both = agree & (r1 > 0)
        rel = np.abs(rs[both] - r1[both]) / r1[both]
        bad = agree & (np.abs(rs - r1) > tol(r1))
        offs = []
        for y, x in zip(*np.nonzero(bad)):
            around = r1[max(y - 1, 0):y + 2, [(x - 1) % W, x, (x + 1) % W]]
            around = around[around > 0]
            lo, hi = float(around.min()), float(around.max())
            v = float(rs[y, x])
            offs.append(dict(
                row=int(y), col=int(x), single=float(r1[y, x]), wedged=v,
                around=(lo, hi), seam=int(min(x % (W // 2), -x % (W // 2))),
                within=lo - tol(lo) <= v <= hi + tol(hi)))
        if ((~agree).mean() >= 0.002 or len(offs) > WEDGE_OFF
                or not all(o["within"] for o in offs)):
            fail(f"2x2 region x az render off the wedge tolerance: sky "
                 f"flips {(~agree).mean():.5f}, pixels beyond 5e-3 "
                 f"relative + 1 m {offs[:8]}")
        kind = " textured hybrid" if textured else ""
        log(f"[33] region render {W}x{H}{kind}, every rank's local function of {r} bands: {launches[name]} "
            f"{name} launches, {res_launches} {res_name}; image and ranges "
            f"== single render bitwise; 2 bands x 2 wedges: sky flips "
            f"{(~agree).mean():.6f} (< 0.002), pixels beyond 5e-3 rel + 1 m "
            f"{len(offs)} (at most {WEDGE_OFF}, each inside its "
            f"neighbourhood's span): "
            f"{offs}; largest relative {rel.max():.4f}")

    # 4-5. through a one-rank NCCL group
    h = horizonator(34.4, -117.6, W, H, dir_dems=tiles, device=dev)
    # the plain API render before the process group exists, and after
    ms_solo = cuda_ms(lambda i: h.render(-180 + i, 180 + i), API_RUNS,
                      warmup=1)
    hr = horizonator(34.4, -117.6, W, H, dir_dems=tiles, device=dev,
                     region_mesh="auto")
    backend = str(dist.get_backend())
    if backend != "nccl" or dist.get_world_size() != 1:
        fail(f"region_mesh='auto' made a {backend} group of "
             f"{dist.get_world_size()}")
    march_band.launches = resolve.launches = 0
    img_r, rng_r = hr.render(-180, 180)
    api_launches = {"window_march_band": march_band.launches,
                    "resolve": resolve.launches}
    img_1, rng_1 = h.render(-180, 180)
    if min(api_launches.values()) < 1 or not (
            np.array_equal(img_r, img_1) and np.array_equal(rng_r, rng_1)):
        fail(f"API region render (launches {api_launches}) != plain API "
             f"render")
    # the textured API on a tile cache of real PNG files, decoded by
    # tiles._decode_tile_bgr (the port's own decoder)
    tile_dir = tempfile.mkdtemp(dir=tiles)
    xs, ys = atlas_tiles(h)
    files, want_atlas = seeded_tiles(xs, ys)
    write_tile_cache(tile_dir, files)
    tkw = dict(dir_dems=tiles, device=dev, render_texture=True,
               dir_tiles=tile_dir, allow_downloads=False)
    ht = horizonator(34.4, -117.6, W, H, **tkw)
    htr = horizonator(34.4, -117.6, W, H, region_mesh="auto", **tkw)
    want_packed = pack_atlas(torch.from_numpy(want_atlas).to(dev))
    for tag, api in (("plain", ht), ("region", htr)):
        if not torch.equal(api._atlas, want_packed):
            fail(f"{tag} textured API's atlas != the seeded tiles' pixels")
    march_band_textured.launches = resolve_textured.launches = 0
    img_tr, rng_tr = htr.render(-180, 180)
    api_launches.update(window_march_band_textured=(
        march_band_textured.launches), resolve_textured=(
        resolve_textured.launches))
    img_t1, rng_t1 = ht.render(-180, 180)
    if min(api_launches.values()) < 1 or not (
            np.array_equal(img_tr, img_t1) and np.array_equal(rng_tr,
                                                              rng_t1)):
        fail(f"textured API region render (launches {api_launches}) != "
             f"plain textured API render")
    vis_t = float((rng_tr > 0).mean())
    if not 0.05 < vis_t < 0.95 or int(img_tr[rng_tr > 0][:, 1].sum()) == 0:
        fail(f"textured API region render: visible {vis_t}, no colors")
    ms_region, ms_plain_api = interleaved_ms(
        lambda i: hr.render(-180 + i, 180 + i),
        lambda i: h.render(-180 + i, 180 + i), API_RUNS)
    log(f"[33] API region_mesh='auto' through a one-rank {backend} group "
        f"({hr.mosaic.grid.shape} grid, 1 band + masked halo row): "
        f"untextured and textured hybrid (a cache of {len(files)} seeded "
        f"PNG tiles, palette and RGB filtered 0-4, decoded by the port: "
        f"{tuple(htr._atlas.shape)} atlas == their pixels) == the plain "
        f"API's renders bitwise, "
        f"launches {api_launches}; ms a render (median of {API_RUNS} in "
        f"turns, host copies included) region {ms_region:.3f}, plain "
        f"{ms_plain_api:.3f}; the plain one before the group existed "
        f"{ms_solo:.3f}")
    gap = profile_gap(lambda: hr.render(-180, 180),
                      lambda: h.render(-180, 180))
    log(f"[33] region - plain API render, torch.profiler over 2 x 5 "
        f"renders each, a render: profiler events {gap['ops'][0]:.0f} / "
        f"{gap['ops'][1]:.0f}, their self CPU ms {gap['cpu_ms'][0]:.3f} / "
        f"{gap['cpu_ms'][1]:.3f}"
        f", device busy ms {gap['dev_ms'][0]:.4f} / {gap['dev_ms'][1]:.4f}; "
        f"the ops with the most extra host ms: " + "; ".join(
            f"{k} {n_a:g}/{n_b:g} calls, {ms:+.3f} ms"
            for k, n_a, n_b, ms in gap["top"]) + "; most extra device ms: "
        + "; ".join(f"{k[:60]} {n_a:g}/{n_b:g} calls, {ms:+.4f} ms"
                    for k, n_a, n_b, ms in gap["top_dev"]))
    del ht, htr
    rng8 = np.random.default_rng(8)
    lats = list(34.4 + rng8.uniform(-0.2, 0.2, SCALE_BATCH))
    lons = list(-117.6 + rng8.uniform(-0.2, 0.2, SCALE_BATCH))
    march.launches = resolve.launches = 0
    imgs_m, rngs_m = h.render_batch(-180, 180, lats, lons, mesh="auto")
    b_launches = {"window_march": march.launches,
                  "resolve": resolve.launches}
    imgs_1, rngs_1 = h.render_batch(-180, 180, lats, lons)
    if min(b_launches.values()) < 1 or not (
            np.array_equal(imgs_m, imgs_1) and np.array_equal(rngs_m,
                                                              rngs_1)):
        fail(f"render_batch(mesh='auto') (launches {b_launches}) != the "
             f"one-device batch")
    vdem = torch.from_numpy(bench_dem(n=VS_N)).to(dev)
    pts = np.random.default_rng(5).uniform(*COUNT_SPREAD, (COUNT_OBS, 2))
    vkw = dict(out_center_ij=(COUNT_CENTER, COUNT_CENTER),
               out_halfwidth=VS_HW, width=VS_W, cells_per_deg=CPD,
               znear=50.0, zfar=VS_ZFAR, lat_deg=LAT, batch=COUNT_BATCH,
               device=dev)
    march.launches = 0
    counts_m = viewshed_count(vdem, pts.astype(np.float32), mesh="auto",
                              **vkw)
    c_launches = march.launches
    counts_1 = viewshed_count(vdem, pts.astype(np.float32), **vkw)
    if c_launches < 1 or not torch.equal(counts_m, counts_1):
        fail(f"viewshed_count(mesh='auto') != one-device counts")
    log(f"[33] render_batch(mesh='auto') of {SCALE_BATCH} viewpoints "
        f"{W}x{H} == the one-device batch bitwise, launches {b_launches}; "
        f"viewshed_count(mesh='auto') of {COUNT_OBS} observers (config 10's "
        f"shape) == one-device counts exactly, {c_launches} march launches")
    dist.destroy_process_group()

    # 6. the band march's device time against its bound and against a
    # write-only pass over its outputs, and the square's
    outs = 4 * W * k_lim
    fills = {False: fill_ms(outs), True: fill_ms(2 * outs)}
    in_frame = band_in_frame(drive, r)
    recs = []
    for name, fn_k, tex in (
            ("window_march_band", march_band, False),
            ("window_march_band_textured", march_band_textured, True)):
        ms_b, pl_b, bd_b, hl_b = [], [], [], []
        for b in bands:
            idx = b["band"]
            j_off, j_hi = band_bounds(idx, r, nb)
            loc = local_band(dem, idx, r)
            args = (local_band(cp2, idx, r).full_packed, 2) if tex else ()
            ms_b.append(graph_ms(lambda: fn_k(loc, pcol, fscal, k_lim, *args,
                                              j_off, j_hi), GRAPH_LAUNCHES))
            hl_b.append(cuda_ms_run(lambda i: fn_k(
                loc, pcol, fscal, k_lim, *args, j_off, j_hi), HOST_LOOP))
            pl_b.append(cuda_ms_run(lambda i: march_plain(
                loc, pcol, fscal, k_lim, *args, j_offset=j_off, j_hi=j_hi),
                10))
            nbytes = (4 * b["cells"] + pcol.nbytes + fscal.nbytes + outs
                      + (16 * b["cells"] + outs if tex else 0))
            flops = (MARCH_TEX_FLOPS if tex else MARCH_FLOPS) * W * k_lim
            bd_b.append(bound(nbytes, flops, FP32_OPS_PER_S))
            b[name + "_ms"], b[name + "_bound_ms"] = ms_b[-1], bd_b[-1][0]
        rec = kernel_entry(
            name, "horizonator_tpu_torch/kernels/csrc/window_march.cu",
            "horizonator_tpu/render/window.py:" + ("452" if tex else "446"),
            launches[name], 0.0, statistics.mean(ms_b),
            statistics.mean(pl_b), 0, 0, FP32_OPS_PER_S)
        rec["bound_ms"] = statistics.mean(x[0] for x in bd_b)
        rec["bound_by"] = bd_b[0][1]
        rec["fill_ms"] = fills[tex]
        rec["in_frame_ms"] = statistics.mean(in_frame[tex])
        rec["host_loop_ms"] = statistics.mean(hl_b)
        rec["bands"] = [dict(band=b["band"], rows=b["rows"],
                             cells=b["cells"], live_tiles=b["live_tiles"],
                             tiles=b["tiles"], ms=b[name + "_ms"],
                             bound_ms=b[name + "_bound_ms"],
                             fill_ms=fills[tex], in_frame_ms=f,
                             host_loop_ms=h)
                        for b, f, h in zip(bands, in_frame[tex], hl_b)]
        recs.append(rec)
        log(f"[33] {name} device ms a band (graph replay, {GRAPH_LAUNCHES} "
            f"launches): " + ", ".join(
                f"band {b['band']} {b[name + '_ms']:.4f} (bound "
                f"{b[name + '_bound_ms']:.5f}, {b['cells']} cells, "
                f"{b['live_tiles']} of {b['tiles']} tiles live)"
                for b in bands) + f"; mean {rec['ms']:.5f} against bound "
            f"{rec['bound_ms']:.5f} ({rec['bound_ms'] / rec['ms']:.1%}); a "
            f"write-only pass over its {(2 if tex else 1) * outs / 1e6:.2f} "
            f"MB of outputs {fills[tex]:.5f}; in the region render's frame "
            f"(torch.profiler, {BAND_FRAMES} renders) " + ", ".join(
                f"{x:.4f}" for x in in_frame[tex]) + "; host-loop "
            + ", ".join(f"{x:.4f}" for x in hl_b) + f"; plain "
            f"{statistics.mean(pl_b):.4f}; {card}")
    t_sq = graph_ms(lambda: march(dem, pcol, fscal, k_lim), GRAPH_LAUNCHES)
    t_sq_t = graph_ms(lambda: march_textured(dem, pcol, fscal, k_lim, plane,
                                             2), GRAPH_LAUNCHES)
    log(f"[33] square march device ms in this run: {t_sq:.4f}, textured "
        f"{t_sq_t:.4f} (against the parent: --time-march); {card}")
    log(f"[t] phase 33: {time.perf_counter() - t0:.1f} s")
    return recs


def profiling_checks(dev, card, ms5, profile_dir):
    """Phase 34, part 1: profiling.device_time of the bench render beside
    phase 5's CUDA-events median ``ms5`` and the same median measured here
    (which stands for phase 5's when ``ms5`` is None), a PhaseTimer over
    the render's steps and device_time_chain over camera-moved renders."""
    from horizonator_tpu_torch import profiling
    from horizonator_tpu_torch.render import render_panorama
    from horizonator_tpu_torch.render.crossing import (crossing_geometry,
                                                       k_cross_for)
    from horizonator_tpu_torch.render.raymarch import resolve_to_image
    from horizonator_tpu_torch.render.window import march_from_geometry
    dem = torch.from_numpy(bench_dem()).to(dev)
    k = k_cross_for(ZFAR, CPD, LAT, n=N)
    rkw = dict(width=W, height=H, nsteps=k, cells_per_deg=CPD,
               lat_hint_deg=LAT)
    views = [bench_view(dev, i) for i in range(RENDERS + 2)]

    def render(d, q):
        return render_panorama(d, q, **rkw)

    here = cuda_ms(lambda i: render(dem, views[i]), RENDERS)
    dt_ms = 1e3 * profiling.device_time(render, dem, views[0],
                                        iters=RENDERS)
    ms5 = here if ms5 is None else ms5
    if not 0.5 <= dt_ms / ms5 <= 2.0:
        fail(f"profiling.device_time {dt_ms:.3f} ms a viewpoint vs phase "
             f"5's CUDA-events median {ms5:.3f}: more than 2x apart")
    log(f"[34] profiling.device_time(render_panorama) {W}x{H}: "
        f"{dt_ms:.3f} ms a viewpoint (upper median of {RENDERS} calls, "
        f"CUDA events, outputs reduced); phase 5's CUDA-events median "
        f"{ms5:.3f}, the same measured here just before {here:.3f}; "
        f"{card}")

    timer = profiling.PhaseTimer()

    def steps(q):
        with timer.phase("phase34.geometry"):
            geo = crossing_geometry(q, width=W, cells_per_deg=CPD)
            torch.cuda.synchronize()
        with timer.phase("phase34.march"):
            tan, dists = march_from_geometry(dem, q, geo, k_cross=k,
                                             cells_per_deg=CPD,
                                             lat_hint_deg=LAT)
            torch.cuda.synchronize()
        with timer.phase("phase34.resolve"):
            img, rng = resolve_to_image(tan, dists.d_of, geo.az, q,
                                        width=W, height=H, cells_per_deg=CPD)
            torch.cuda.synchronize()
        with timer.phase("phase34.readback"):
            return img.cpu(), rng.cpu()

    img_s, rng_s = steps(views[1])
    img_r, rng_r = render(dem, views[1])
    if not (torch.equal(img_s, img_r.cpu()) and torch.equal(rng_s,
                                                            rng_r.cpu())):
        fail("the PhaseTimer's render steps != render_panorama")
    timer.totals.clear()
    timer.counts.clear()
    for i in range(PHASE_RENDERS):
        steps(views[i])
    log(f"[34] PhaseTimer over {PHASE_RENDERS} renders' steps (host clock, "
        f"each step synchronized); {card}:")
    for line in timer.report().splitlines():
        log(f"    {line}")
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                steps(views[i])
        averages = prof.key_averages()
        missing = sorted(set(timer.totals) - {e.key for e in averages})
        if missing:
            fail(f"phases {missing} missing from the torch.profiler table")
        out = os.path.join(profile_dir, "profile_phases.txt")
        with open(out, "w") as f:
            f.write(f"{card}\n3 renders' steps under PhaseTimer\n"
                    + averages.table(sort_by="self_cuda_time_total",
                                     row_limit=40))
        log(f"[34] profile: every phase in the torch.profiler table; {out}")

    def moved(args, i):
        d, q = args
        return d, q._replace(viewer_cell_i=q.viewer_cell_i + i,
                             viewer_cell_j=q.viewer_cell_j - i)

    chain_ms = 1e3 * profiling.device_time_chain(
        render, dem, views[0], perturb=moved, reps=CHAIN_REPS)
    log(f"[34] profiling.device_time_chain: {chain_ms:.3f} ms a render "
        f"(the fastest of 5 chains of {CHAIN_REPS} camera-moved renders, "
        f"CUDA events); {card}")


def decode_checks(dev, card, tiles):
    """Phase 34, part 2: _png.decode_png of the phase's palette, RGB
    (filters 0-4) and Paeth RGB tiles, native and plain, and of the API
    scene's whole atlas through tiles.build_atlas; the native unfilter
    (g++) must be the one called. Returns the scene's API object, its
    tiles' files, their BGR atlas and a cache of them."""
    import threading
    from horizonator_tpu_torch import _native, _png, horizonator
    from horizonator_tpu_torch import tiles as tiles_mod
    if _native.get_lib() is None:
        fail("the native library did not build (g++): the PNG unfilter "
             "would run in Python")
    calls, lock = {"native": 0, "plain": 0}, threading.Lock()
    native, plain, get_lib = (_native.png_unfilter, _png.unfilter_plain,
                              _native.get_lib)

    def counted(path, fn):
        def wrapped(*a):
            with lock:
                calls[path] += 1
            return fn(*a)
        return wrapped

    _native.png_unfilter = counted("native", native)
    _png.unfilter_plain = counted("plain", plain)
    try:
        pal, pal_png = tile_pixels(1, 0)
        rgb, rgb_png = tile_pixels(0, 0)
        forms = {"palette, filter 0": (pal_png, pal),
                 "RGB, filters 0-4": (rgb_png, rgb),
                 "RGB, Paeth": (png_file(rgb, filters=(4,)), rgb)}
        for form, (data, want) in forms.items():
            ms = {}
            for path, n in (("native", DECODES), ("plain", PLAIN_DECODES)):
                _native.get_lib = get_lib if path == "native" else (
                    lambda: None)
                before = dict(calls)
                ts = []
                for _ in range(n):
                    t0 = time.perf_counter()
                    got = _png.decode_png(data)
                    ts.append(time.perf_counter() - t0)
                    if not np.array_equal(got, want):
                        fail(f"decode_png of the {form} tile ({path}) != "
                             f"its pixels")
                used = {p: calls[p] - before[p] for p in calls}
                other = "plain" if path == "native" else "native"
                if used[path] != n or used[other]:
                    fail(f"{n} decodes of the {form} tile on the {path} "
                         f"path called the unfilters {used}")
                ms[path] = 1e3 * statistics.median(ts)
            _native.get_lib = get_lib
            log(f"[34] decode_png of a 256x256 {form} tile "
                f"({len(data)} bytes): native unfilter {ms['native']:.3f} ms "
                f"(median of {DECODES}), plain {ms['plain']:.3f} ms (median "
                f"of {PLAIN_DECODES}), bitwise its pixels; host CPU of "
                f"{card}")
        h = horizonator(34.4, -117.6, W, H, dir_dems=tiles, device=dev)
        xs, ys = atlas_tiles(h)
        t0 = time.perf_counter()
        files, want = seeded_tiles(xs, ys)
        cache = tempfile.mkdtemp(dir=tiles)
        write_tile_cache(cache, files)
        gen_s = time.perf_counter() - t0
        before = dict(calls)
        t0 = time.perf_counter()
        atlas, _ = tiles_mod.build_atlas(
            h.viewer_lat, h.viewer_lon, h.mosaic.radius_cells,
            h.mosaic.cells_per_deg, h.mosaic.origin_cell_lon_deg,
            h.mosaic.origin_cell_lat_deg, dir_tiles=cache,
            allow_downloads=False)
        atlas_s = time.perf_counter() - t0
        used = {p: calls[p] - before[p] for p in calls}
        if not np.array_equal(atlas, want):
            fail("build_atlas of the seeded tile cache != the tiles' pixels")
        if used["native"] != len(files) or used["plain"]:
            fail(f"the atlas's {len(files)} tiles called the unfilters "
                 f"{used}")
    finally:
        _native.png_unfilter, _png.unfilter_plain = native, plain
        _native.get_lib = get_lib
    log(f"[34] the API scene's atlas: {len(xs)} x {len(ys)} z12 tiles "
        f"{atlas.shape}, written in {gen_s:.2f} s, build_atlas (8 threads, "
        f"native unfilter) {1e3 * atlas_s:.1f} ms = "
        f"{1e3 * atlas_s / len(files):.3f} ms a tile, == the tiles' pixels; "
        f"host CPU of {card}")
    return h, files, want, cache


def svg_check(dev, card, tiles):
    """Phase 34, part 3: the CLI in-process with --pois to .svg on phase
    6's tiles; its embedded PNG decoded bitwise the API's image."""
    import base64
    from horizonator_tpu_torch import _png, cli, horizonator
    with tempfile.TemporaryDirectory() as td:
        svg, pj = os.path.join(td, "pano.svg"), os.path.join(td, "pois.json")
        write_pois(pj, 34.4, -117.6, 64, 34)
        t0 = time.perf_counter()
        rc = cli.main(["--width", str(W), "--height", str(H), "--image", svg,
                       "--pois", pj, "--dirdems", tiles, "--device",
                       dev.type, "34.4", "-117.6", "0", "180"])
        cli_s = time.perf_counter() - t0
        with open(svg, encoding="utf-8") as f:
            text = f.read()
    m = re.search(r'xlink:href="data:image/png;base64,([A-Za-z0-9+/=]+)"',
                  text)
    if rc != 0 or m is None:
        fail(f"CLI --pois .svg rc {rc}, embedded PNG found: {m is not None}")
    got = _png.decode_png(base64.b64decode(m.group(1)))
    img = horizonator(34.4, -117.6, W, H, dir_dems=tiles, device=dev,
                      render_radius_m=40000.0).render(-180, 180)[0]
    if not np.array_equal(got, img[:, :, ::-1]):
        fail("the SVG's embedded PNG != the API's image")
    texts, links = text.count("<text "), text.count("<a xlink:href=")
    if texts < 1 or links < 1:
        fail(f"the SVG has {texts} text and {links} link elements")
    log(f"[34] CLI {W}x{H} --pois (64) -> .svg ({len(text) / 1e6:.2f} MB) "
        f"in {cli_s:.2f} s: embedded PNG decoded bitwise the API's image, "
        f"{texts} text and {links} link elements; {card}")


def loopback_fetches(dev, card, tiles, h, files, want, cache):
    """Phase 34, part 4: a loopback server of the seeded tiles (every other
    one with an Expires header) and an Overpass-shaped answer. A textured
    API with downloads into an empty cache, the viewer's /tiles/ route on
    a cache miss, and fetch_peaks."""
    import threading
    import urllib.parse
    from http.server import ThreadingHTTPServer
    from horizonator_tpu_torch import horizonator, viewer
    from horizonator_tpu_torch.annotate import peaks
    from horizonator_tpu_torch.render.texture import pack_atlas
    from horizonator_tpu_torch.tiles import USER_AGENT
    expires = "Wed, 21 Oct 2037 07:28:00 GMT"
    headers = {p: [("Expires", expires)] for k, p in enumerate(sorted(files))
               if k % 2 == 0}
    rng = np.random.default_rng(34)
    elements = [{"type": "node", "id": k, "lat": 34.4 + rng.uniform(-.2, .2),
                 "lon": -117.6 + rng.uniform(-.2, .2),
                 "tags": {"natural": "peak", "name": f"peak {k}",
                          "ele": f"{rng.uniform(500, 3000):.1f}"}}
                for k in range(8)]
    elements.append({"type": "node", "id": 8, "lat": 34.5, "lon": -117.5,
                     "tags": {"natural": "peak"}})       # no ele: dropped
    srv = LoopbackFiles(files, headers, json.dumps(
        {"version": 0.6, "elements": elements}).encode())
    try:
        fmt = srv.url + "/%d/%d/%d.png"
        with tempfile.TemporaryDirectory() as empty:
            t0 = time.perf_counter()
            ht = horizonator(34.4, -117.6, W, H, dir_dems=tiles, device=dev,
                             render_texture=True, dir_tiles=empty,
                             tiles_url_fmt=fmt, allow_downloads=True)
            fetch_s = time.perf_counter() - t0
            if sorted(srv.hits) != sorted(files) \
                    or set(srv.agents) != {USER_AGENT}:
                fail(f"the textured API fetched {len(srv.hits)} of "
                     f"{len(files)} tiles, agents {set(srv.agents)}")
            for path, data in files.items():
                dst = os.path.join(empty, "mapnik", *path.strip("/").split(
                    "/"))
                with open(dst, "rb") as f:
                    if f.read() != data:
                        fail(f"fetched tile {path} != the server's bytes")
                if os.path.exists(dst + ".expires") != (path in headers):
                    fail(f"tile {path}: .expires written "
                         f"{os.path.exists(dst + '.expires')}")
            if not torch.equal(ht._atlas, pack_atlas(torch.from_numpy(
                    want).to(dev))):
                fail("the downloaded atlas != the tiles' pixels")
            hl = horizonator(34.4, -117.6, W, H, dir_dems=tiles, device=dev,
                             render_texture=True, dir_tiles=cache,
                             allow_downloads=False)
            a, b = ht.render(-180, 180), hl.render(-180, 180)
            if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1],
                                                                  b[1])):
                fail("textured render from downloaded tiles != from the "
                     "local cache")
        log(f"[34] textured API with downloads from a loopback server into "
            f"an empty cache: {len(files)} tiles fetched through urllib in "
            f"{fetch_s:.2f} s (the constructor), files byte for byte, "
            f".expires for the {len(headers)} sent with Expires, atlas == "
            f"the tiles' pixels, render bitwise one from a local cache; "
            f"{card}")

        n0 = len(srv.hits)
        miss = sorted(files)[1]
        with tempfile.TemporaryDirectory() as vt:
            state = viewer.ViewerState(h, 0.0, 45.0, 100.0, 40000.0,
                                       dir_tiles=vt, tiles_url_fmt=fmt)
            httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                        viewer.make_handler(state))
            server = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            server.start()
            try:
                body, ctype = http(
                    f"http://127.0.0.1:{httpd.server_address[1]}",
                    "/tiles" + miss)
            finally:
                httpd.shutdown()
                httpd.server_close()
                server.join(timeout=10)
            cached = os.path.join(vt, "mapnik", *miss.strip("/").split("/"))
            if body != files[miss] or srv.hits[n0:] != [miss] \
                    or not os.path.exists(cached):
                fail(f"viewer /tiles{miss}: {len(body)} bytes, upstream hits "
                     f"{srv.hits[n0:]}, cached {os.path.exists(cached)}")
        log(f"[34] viewer /tiles{miss} on a cache miss: fetched upstream "
            f"once, served and cached the server's bytes ({ctype})")

        query = peaks.overpass_query(34.4, -117.6, 25000.0)
        got = peaks.fetch_peaks(34.4, -117.6, 25000.0,
                                url=srv.url + "/api/interpreter")
        form = urllib.parse.urlencode({"data": query}).encode()
        if got != peaks.parse_elements(elements) or len(got) != 8 \
                or srv.posts != [("/api/interpreter",
                                  "application/x-www-form-urlencoded",
                                  form)]:
            fail(f"fetch_peaks: {len(got)} peaks, posts {srv.posts}")
        log(f"[34] fetch_peaks through urllib: a form-encoded data= body "
            f"({len(form)} bytes), {len(got)} peaks of {len(elements)} "
            f"elements")
    finally:
        srv.close()


def host_paths_phase(dev, card, tiles, ms5=None, profile_dir=None):
    """Phase 34: profiling and the host paths without PIL or requests, on
    phase 6's tiles (``ms5``: phase 5's CUDA-events median, None under
    --front)."""
    import importlib
    import importlib.util
    t0 = time.perf_counter()
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "requests")}
    blocked = ("PIL", "PIL.Image", "requests")
    saved = {m: sys.modules[m] for m in blocked if m in sys.modules}
    for m in blocked:
        sys.modules[m] = None
    try:
        for m in ("PIL", "requests"):
            try:
                importlib.import_module(m)
            except ImportError:
                continue
            fail(f"{m} still imports after blocking")
        log("[34] importable before the phase: "
            + ", ".join(f"{m} {'yes' if v else 'no'}" for m, v in
                        have.items())
            + "; both blocked for the phase")
        profiling_checks(dev, card, ms5, profile_dir)
        h, files, want, cache = decode_checks(dev, card, tiles)
        svg_check(dev, card, tiles)
        loopback_fetches(dev, card, tiles, h, files, want, cache)
    finally:
        for m in blocked:
            sys.modules.pop(m, None)
        sys.modules.update(saved)
    log(f"[t] phase 34: {time.perf_counter() - t0:.1f} s")


def scale_out_only():
    """--scale-out: build the kernels, then phase 33 alone."""
    from horizonator_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    build.build()
    build.library()
    card = card_line()
    with tempfile.TemporaryDirectory() as tiles:
        write_tiles(tiles, 34, -118)
        recs = scale_out_phase(torch.device("cuda"), card, tiles)
    print(card)
    print(json.dumps({"kernels": recs}))
    return 0


def front_only():
    """--front: build the kernels, then phases 32 and 34."""
    from horizonator_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    build.build()
    build.library()
    card = card_line()
    with tempfile.TemporaryDirectory() as tiles:
        write_tiles(tiles, 34, -118)
        front_phase(torch.device("cuda"), card, tiles)
        host_paths_phase(torch.device("cuda"), card, tiles)
    print(card)
    return 0


def oracle_only():
    """--oracle: build the kernels, then phases 29-31 alone."""
    from horizonator_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    build.build()
    build.library()
    card = card_line()
    records = oracle_phases(torch.device("cuda"), card, int32_ops_per_s()[0])
    print(card)
    print(json.dumps(records))
    return 0


def near_band_phase(dem, p, geo):
    """Phase 2's near band: the kernel against near_band_plain at the bench
    shape (the pano cell's: 4096 columns, n_near 4, znear 100 m's patch),
    bitwise; its device ms by graph replay against its bound (the columns'
    az, e and scale read, the patch's cells, near_hi and the (W, n_near)
    tangents written) and the plain version's ms. Returns the kernel
    entry's (err, ms, plain_ms, bytes, ops); its launches are phase 5's,
    the main path's."""
    from horizonator_tpu_torch.kernels.near_band import (near_band,
                                                         near_band_plain)
    from horizonator_tpu_torch.render.crossing import N_NEAR
    from horizonator_tpu_torch.render.window import near_patch_size
    patch_n = near_patch_size(100.0, CPD, LAT)
    nkw = dict(n_near=N_NEAR, patch_n=patch_n)
    got = near_band(dem, p, geo, want_samples=True, **nkw)
    ref = near_band_plain(dem, p, geo, **nkw)
    torch.cuda.synchronize()
    for name, a, b in (("tanel", got.tanel, ref[0]),
                       ("near_hi", got.near_hi, ref[1]),
                       ("dropped", got.dropped, ref[2]),
                       *zip(("dq", "iq", "jq"), got.samples, ref[3])):
        if not torch.equal(a, b):
            fail(f"near band {name} != plain: {int((a != b).sum())} differ")
    err = max_abs(got.tanel, ref[0])
    t_k = graph_ms(lambda: near_band(dem, p, geo, **nkw).tanel,
                   GRAPH_LAUNCHES)
    t_p = cuda_ms_run(lambda i: near_band_plain(dem, p, geo, **nkw), 50)
    nbytes = W * (3 * 4 + 4 + 4 * N_NEAR) + 4 * patch_n ** 2 + 4 * 9
    ops = W * (NEAR_FLOPS_COLUMN + NEAR_FLOPS_SAMPLE * N_NEAR)
    b_ms, b_by = bound(nbytes, ops, FP32_OPS_PER_S)
    log(f"[2] near_band_kernel ({W}, {N_NEAR}), patch {patch_n}: kernel == "
        f"plain bitwise (tangents, near_hi, dropped {int(got.dropped)}, dq, "
        f"iq, jq); device ms (graph replay of {GRAPH_LAUNCHES}) {t_k:.5f} "
        f"against a bound of {b_ms:.5f} by {b_by} "
        f"({nbytes / 1e3:.1f} kB, {ops / 1e6:.2f} M ops): "
        f"{100 * b_ms / t_k:.2f}%; plain {t_p:.4f} ms; {card_line()}")
    return err, t_k, t_p, nbytes, ops


def main(profile_dir=None):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from horizonator_tpu_torch import horizonator
    from horizonator_tpu_torch.kernels import build
    from horizonator_tpu_torch.kernels.near_band import near_band
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
    t_start = t0 = time.perf_counter()
    path, nvcc_s, nvcc_log = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    card = card_line()
    int32_rate, sm_mhz, sms = int32_ops_per_s()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; {sms} SMs "
        f"at clocks.max.sm {sm_mhz:g} MHz: int32 {int32_rate / 1e12:.2f} "
        f"Tops/s")
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
    near_args = near_band_phase(dem, p, geo)

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
    march.launches = resolve.launches = near_band.launches = 0
    img, rng, guard = render_panorama(dem, p, with_dropped=True, **rkw)
    torch.cuda.synchronize()
    launches = {"window_march": march.launches, "resolve": resolve.launches,
                "near_band": near_band.launches}
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

    # suite config 2's annotation range queries (benchmarks/suite.py:110-
    # 114): 512 POIs x a 12-row fuzz, one gather on the ranges
    poi = np.arange(POIS_N)
    q_rows = np.clip((300 + (poi * 7) % 400)[:, None]
                     + np.arange(-6, 6)[None, :], 0, H - 1)
    q_cols = np.broadcast_to(((poi * 8) % W)[:, None], q_rows.shape)
    rows_t = torch.from_numpy(q_rows).to(dev)
    cols_t = torch.from_numpy(np.ascontiguousarray(q_cols)).to(dev)
    q_dev = rng[rows_t, cols_t]
    if not np.array_equal(q_dev.cpu().numpy(),
                          rng.cpu().numpy()[q_rows, q_cols]):
        fail("config 2's POI range queries != the host copy's gather")

    def render_and_query(i):
        return render_panorama(dem, params[i], **rkw)[1][rows_t, cols_t]

    ms_annot = cuda_ms(render_and_query, RENDERS)
    ms_query = cuda_ms(lambda i: rng[rows_t, cols_t], RENDERS)
    log(f"[5] config 2: {POIS_N} POI range queries x 12 rows ({q_dev.numel()}"
        f" ranges, one gather) == numpy's gather of the host copy; render + "
        f"queries {ms_annot:.3f} ms/viewpoint (median of {RENDERS}), the "
        f"queries alone {ms_query:.4f} ms")

    # each kernel alone vs its plain version, at the main path's shapes
    pcol, fscal = pcol_fscal(geo, p)
    k_lim = tan_k.shape[1] - N_NEAR
    hl_march = cuda_ms_run(lambda i: march(dem, pcol, fscal, k_lim), HOST_LOOP)
    hl_res = cuda_ms_run(lambda i: resolve(y_k, H, amax, int_first),
                         HOST_LOOP)
    log(f"[5] host-loop ms (wrapper called {HOST_LOOP} times from Python "
        f"between two CUDA events; the launch interval, not the kernel): "
        f"window march {hl_march:.4f}, resolve {hl_res:.4f}")
    t_march = graph_ms(lambda: march(dem, pcol, fscal, k_lim), GRAPH_LAUNCHES)
    t_res = graph_ms(lambda: resolve(y_k, H, amax, int_first), GRAPH_LAUNCHES)
    t_march_p = cuda_ms_run(lambda i: march_plain(dem, pcol, fscal, k_lim),
                            50)
    t_res_p = cuda_ms_run(lambda i: resolve_plain(y_k, H, amax, int_first),
                          50)
    log(f"[5] device ms (replay of a CUDA graph of {GRAPH_LAUNCHES} "
        f"launches, inputs warm in L2): window march {t_march:.4f} (plain "
        f"{t_march_p:.4f}), resolve {t_res:.4f} (plain {t_res_p:.4f}); "
        f"yardsticks: fill_ of the march's {4 * W * k_lim / 1e6:.2f} MB of "
        f"outputs {fill_ms(4 * W * k_lim):.4f}, of the resolve's "
        f"{9 * W * H / 1e6:.2f} MB {fill_ms(9 * W * H):.4f}")

    # the march's time against its step count: what a launch costs before
    # its first sample, and what each further step tile adds
    scan = {kk: graph_ms(lambda: march(dem, pcol, fscal, kk), GRAPH_LAUNCHES)
            for kk in (64, 192, 384, k_lim, 2 * k_lim)}
    log(f"[5] window march device ms by step count ({W} columns, "
        f"{GRAPH_LAUNCHES} launches a graph): "
        + ", ".join(f"K {kk}: {t:.4f}" for kk, t in scan.items()))

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
        out = os.path.join(profile_dir, "profile_render.txt")
        busy, in_frame = profile_renders(
            lambda i: render_panorama(dem, params[i], **rkw), 5, card, out,
            f"5 renders {W}x{H}",
            ("window_march_kernel<false", "resolve_kernel<false"))
        log(f"[5] profile: device busy {busy:.3f} ms per render of "
            f"{ms_kernel:.3f} ms ({100 * busy / ms_kernel:.1f}%); table in "
            f"{out}")
        log("[5] profile: mean device ms inside the frame: "
            + ", ".join(f"{k} {v:.4f}" for k, v in in_frame.items())
            + f" (graph replay: march {t_march:.4f}, resolve {t_res:.4f})")

    # -- 6. the API -------------------------------------------------------
    tiles_dir = tempfile.TemporaryDirectory()     # phases 6, 10, 12
    tiles = tiles_dir.name
    write_tiles(tiles, 34, -118)
    h = horizonator(34.4, -117.6, W, H, dir_dems=tiles, device=dev)
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
    del h

    # bounds at these shapes: the march must read the DEM cells within
    # zfar of the viewer and the per-column parameters and write (W, K)
    # tangents; the resolve reads (W, K) rows and writes (W, H) idx,
    # alpha and ok (9 bytes), its operations those of a merge of K keys
    # against H thresholds per column (~4 per key, ~12 per row)
    cells = annulus_cells(N, N / 2, N / 2, 0.0, ZFAR,
                          6371000.0 * math.pi / 180.0 / CPD, LAT)
    march_bytes = 4 * cells + pcol.nbytes + fscal.nbytes + 4 * W * k_lim
    resolve_bytes = y_k.nbytes + 9 * W * H
    resolve_ops = W * (4 * y_k.shape[1] + 12 * H)
    log(f"[5] bounds: {cells} DEM cells within zfar ({4 * cells / 1e6:.2f} "
        f"MB) of the {dem.nbytes / 1e6:.1f} MB DEM; march moves "
        f"{march_bytes / 1e6:.2f} MB, resolve {resolve_bytes / 1e6:.2f} MB")

    ctx = dict(dev=dev, dem=dem, p=p, geo=geo, params=params, mkw=mkw,
               rkw=rkw, tan_k=tan_k, y_k=y_k, res_k=out_k, rng=rng,
               dists=dists, pcol=pcol, fscal=fscal, k_lim=k_lim, card=card,
               disk_cells=cells, march_bytes=march_bytes,
               resolve_bytes=resolve_bytes, resolve_ops=resolve_ops,
               int32_rate=int32_rate)
    log(f"[t] phases 1-6: {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    tex_kernels = textured_phases(ctx, tiles, profile_dir)
    log(f"[t] phases 7-10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probe_kernels = probe_phase(int32_rate, t_res, nvcc_log)
    log(f"[t] phase 11: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli_phase(tiles)
    tiles_dir.cleanup()
    log(f"[t] phase 12: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    edge_phase(dev)
    log(f"[t] phase 13: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    march_edge_phase(dev)
    log(f"[t] phase 14: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    batch_march_edge_phase(dev)
    log(f"[t] phase 18: {time.perf_counter() - t0:.1f} s")
    del ctx, dem, tan_k, tan_p, y_k, img, rng, img_p, rng_p
    lod_records = lod_phases(dev, card, int32_rate, profile_dir)
    srtm1_phase(dev, int32_rate)
    batch_records = batch_window_phases(dev, card, int32_rate, profile_dir)
    batch_records = {k: [v] for k, v in batch_records.items()}
    for k, v in batch_lod_phase(dev, card, int32_rate, profile_dir).items():
        batch_records.setdefault(k, []).append(v)
    api_paging_phase(dev)
    batch_records["window_march"] += [
        sweep_phase(dev, card, profile_dir),
        raster_phase(dev, card, profile_dir)]
    count_rec, resample_rec = count_phase(dev, card, profile_dir)
    batch_records["window_march"].append(count_rec)
    shadow_phase(dev, card)
    with tempfile.TemporaryDirectory() as tiles:      # phase 6's tiles again
        write_tiles(tiles, 34, -118)
        api_shadow_phase(dev, card, tiles)
        los_phase(dev, card, tiles)
    oracle_records = oracle_phases(dev, card, int32_rate)
    with tempfile.TemporaryDirectory() as tiles:      # phase 6's tiles again
        write_tiles(tiles, 34, -118)
        front_phase(dev, card, tiles, img6, rng6)
        scale_kernels = scale_out_phase(dev, card, tiles)
        host_paths_phase(dev, card, tiles, ms_kernel, profile_dir)

    kernels = [
        kernel_entry("window_march",
                     "horizonator_tpu_torch/kernels/csrc/window_march.cu",
                     "horizonator_tpu/render/window.py:446",
                     launches["window_march"], march_err, t_march, t_march_p,
                     march_bytes, MARCH_FLOPS * W * k_lim, FP32_OPS_PER_S),
        kernel_entry("resolve",
                     "horizonator_tpu_torch/kernels/csrc/resolve.cu",
                     "horizonator_tpu/render/resolve_window.py:117",
                     launches["resolve"], resolve_err, t_res, t_res_p,
                     resolve_bytes, resolve_ops, int32_rate),
        kernel_entry("near_band",
                     "horizonator_tpu_torch/kernels/csrc/near_band.cu",
                     "none: the JAX near band is jnp glue "
                     "(horizonator_tpu/render/window.py:1024-1114)",
                     launches["near_band"], *near_args, FP32_OPS_PER_S),
        *tex_kernels,
        *probe_kernels,
        *scale_kernels,
        resample_rec,
    ]
    for entry in kernels:     # the LOD render's launches of the same entry
        entry.update(lod_records.get(entry["name"], {}))
        if entry["name"] in batch_records:  # and the batches' (19-21)
            entry["batch"] = batch_records[entry["name"]]
        if entry["name"] in oracle_records:  # and the oracle paths' (29-31)
            entry["oracle"] = oracle_records[entry["name"]]
    log(f"[t] all phases: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def time_march(root, tag):
    """--time-march: the march entries of the package under ``root`` at the
    bench shape, the square ones and the banded ones on phase 33's SCALE_R
    bands, on the device clock, with ptxas's lines for every instance."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from horizonator_tpu_torch.kernels import build
    from horizonator_tpu_torch.kernels.window_march import (
        march, march_band, march_band_textured, march_textured)
    from horizonator_tpu_torch.parallel.regions import band_bounds, local_band
    from horizonator_tpu_torch.render import make_params
    from horizonator_tpu_torch.render.crossing import (N_NEAR,
                                                       crossing_geometry,
                                                       k_cross_for)
    from horizonator_tpu_torch.render.texture import ColorPlanes2x
    from horizonator_tpu_torch.render.window import step_budget
    _, _, nvcc_log = build.build()
    build.library()
    dev = torch.device("cuda")
    dem = torch.from_numpy(bench_dem()).to(dev)
    p = make_params(device=dev, viewer_cell_i=N / 2, viewer_cell_j=N / 2,
                    viewer_z=900.0, cos_viewer_lat=math.cos(math.radians(
                        LAT)), az_rad0=-math.pi, az_rad1=math.pi,
                    znear=100.0, zfar=ZFAR, znear_color=100.0,
                    zfar_color=ZFAR)
    geo = crossing_geometry(p, width=W, cells_per_deg=CPD)
    pcol = torch.stack([geo.a, geo.t, geo.e, geo.scale, geo.axis0.float(),
                        geo.sign.float(), geo.j_dom.float(),
                        torch.zeros_like(geo.a)], 1).contiguous()
    fscal = torch.stack([p.viewer_z, p.znear, p.zfar, p.curv])
    k = step_budget(k_cross_for(ZFAR, CPD, LAT, n=N), N)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    plane = torch.randint(0, 1 << 24, (2 * N, 2 * N), generator=gen,
                          device=dev, dtype=torch.int32)
    r, nb = SCALE_R, N // SCALE_R
    calls = [("march", march, (dem, pcol, fscal, k), False),
             ("textured", march_textured, (dem, pcol, fscal, k, plane, 2),
              True)]
    for idx in range(r):
        j_off, j_hi = band_bounds(idx, r, nb)
        loc = local_band(dem, idx, r)
        loc_c = local_band(ColorPlanes2x(plane), idx, r).full_packed
        calls += [(f"band {idx}", march_band,
                   (loc, pcol, fscal, k, j_off, j_hi), False),
                  (f"band {idx} textured", march_band_textured,
                   (loc, pcol, fscal, k, loc_c, 2, j_off, j_hi), True)]
    entries = [(name, lambda fn=fn, args=args: fn(*args))
               for name, fn, args, _ in calls]
    # a tree whose entries take out=: each also into lanes [4, 4 + k) of a
    # (W, 4 + k) field, the layout the render's in-place field gives them
    strided = "out" in inspect.signature(march).parameters
    if strided:
        def into_field(fn, args, tex):
            f = torch.empty((W, N_NEAR + k), device=dev)
            kw = dict(out=f[:, N_NEAR:])
            if tex:
                kw["tex_out"] = torch.empty(
                    (W, N_NEAR + k), dtype=torch.int32,
                    device=dev)[:, N_NEAR:]
            return fn(*args, **kw)
        entries += [(f"{name} strided",
                     lambda fn=fn, args=args, tex=tex: into_field(fn, args,
                                                                  tex))
                    for name, fn, args, tex in calls]
    times = {name: [graph_ms(fn, GRAPH_LAUNCHES) for _ in range(7)]
             for name, fn in entries}
    med = {name: statistics.median(t) for name, t in times.items()}

    def band_means(suffix):
        untex, tex = (statistics.mean(med[f"band {i}{kind}{suffix}"]
                                      for i in range(r))
                      for kind in ("", " textured"))
        return f"mean a band {untex:.5f}, textured {tex:.5f}"
    log(f"{tag}: " + ", ".join(
        f"{name} {med[name]:.5f} ({min(t):.5f}-{max(t):.5f})"
        for name, t in times.items())
        + f" ms at ({W}, {k}); {band_means('')}"
        + (f"; strided {band_means(' strided')}" if strided else "")
        + f"; {card_line()}")
    for name, (regs, st, ld) in ptxas_table(nvcc_log).items():
        m = re.search(r"(window_march(?:_band)?(?:_tex)?_kernel)I(Lb\dE)+E",
                      name)
        if m:
            flags = ", ".join(re.findall(r"Lb(\d)E", m[0]))
            log(f"    {m[1]}<{flags}>: {regs} registers, spills {st} / {ld} "
                f"bytes")
    return 0


def time_shadows(root, tag):
    """--time-shadows: shadow_light of the package under ``root`` over the
    bench DEM at phase 26's suns, the median ms of 5 calls each."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from horizonator_tpu_torch.ops.shadows import shadow_light
    z = torch.from_numpy(bench_dem()).to(torch.device("cuda"))
    suns = (*SHADOW_SUNS, (q16_azimuth(CPD, LAT), 20.0))
    times = [cuda_ms(lambda i: shadow_light(
        z, cells_per_deg=CPD, lat_deg=LAT, sun_az_deg=az, sun_alt_deg=alt),
        5) for az, alt in suns]
    log(f"{tag}: shadow_light {N}^2 ms at suns "
        + ", ".join(f"({az:g}, {alt:g}) {t:.3f}"
                    for (az, alt), t in zip(suns, times))
        + f"; {card_line()}")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--time-march" in args:
        i = args.index("--time-march")
        sys.exit(time_march(args[i + 1], args[i + 2]))
    if "--time-shadows" in args:
        i = args.index("--time-shadows")
        sys.exit(time_shadows(args[i + 1], args[i + 2]))
    if "--oracle" in args:
        sys.exit(oracle_only())
    if "--front" in args:
        sys.exit(front_only())
    if "--scale-out" in args:
        sys.exit(scale_out_only())
    sys.exit(main(profile_dir=args[args.index("--profile") + 1]
                  if "--profile" in args else None))
