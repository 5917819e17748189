"""Port parity for profiling.py: ``PhaseTimer`` / ``phase`` / ``report``
against horizonator_tpu.profiling (its report string equal on the same
recorded phases, ties included), the phase ranges in torch.profiler, and
``device_time`` / ``device_time_chain`` on CPU tensors with a fake
``perf_counter`` in the port's module (the statistic, the clamp after the
pull's cost, the untimed warm-up, ``perturb``'s indices, the reduced
leaves). Importing the module loads no JAX.

The program's spans and counters: with no profiler running, ``phase``,
``count`` and ``sync`` record nothing and hand back the shared no-op;
under torch.profiler the spans lie nested on its timeline as user
annotations, and ``snapshot`` gives their counts, totals, self times, the
roots and the counters (a fake ``perf_counter``); a tiny CPU render,
``viewshed_count`` and ``viewshed_sweep`` record their span trees and the
host syncs audited on their paths; a textured API's constructor records
its atlas and planes, its render the near colours and the hybrid near
field (or its fallback) with the untextured render's syncs.
"""

import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from horizonator_tpu import profiling as jprof
from horizonator_tpu_torch import profiling as tprof

REPO = Path(__file__).resolve().parent.parent

PHASES = [("upload", 0.0125, 3), ("render", 0.25, 10), ("init", 0.0125, 1),
          ("a very long phase name past the column", 1.5, 2),
          ("readback", 0.0031, 7)]


def test_report_equals_jax():
    jt, tt = jprof.PhaseTimer(), tprof.PhaseTimer()
    for t in (jt, tt):
        for name, total, count in PHASES:      # "upload" ties "init"
            t.totals[name] = total
            t.counts[name] = count
    assert tt.report() == jt.report()
    assert tt.report().splitlines()[1].startswith("render")
    assert tt.report().index("upload") < tt.report().index("init")
    assert tprof.PhaseTimer().report() == jprof.PhaseTimer().report() == ""


def test_phase_accumulates(monkeypatch):
    clock = iter([1.0, 1.5, 2.0, 2.25, 3.0, 3.5])
    monkeypatch.setattr(tprof, "perf_counter", lambda: next(clock))
    t = tprof.PhaseTimer()
    with t.phase("render"):
        pass
    with t.phase("upload"):
        pass
    with t.phase("render"):
        pass
    assert dict(t.totals) == {"render": 1.0, "upload": 0.25}
    assert dict(t.counts) == {"render": 2, "upload": 1}
    # the module-level phase / report over the module's one timer
    # module-level spans record while torch.profiler runs
    monkeypatch.setattr(tprof, "_global_timer", tprof.PhaseTimer())
    clock = iter([0.0, 0.002])
    with profile(activities=[ProfilerActivity.CPU]):
        with tprof.phase("probe"):
            pass
    assert tprof._global_timer.counts["probe"] == 1
    assert tprof.report() == tprof._global_timer.report()
    assert tprof.report().startswith("probe") and "2.00 ms total" in \
        tprof.report()


def test_phase_in_torch_profiler():
    t = tprof.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("hz_probe_phase"):
            torch.ones(8).sum()
    assert "hz_probe_phase" in {e.key for e in prof.key_averages()}
    assert t.counts["hz_probe_phase"] == 1


class FakeClock:
    """perf_counter stand-in: each (t0, t1) pair spans the next duration;
    logs its reads into ``log`` beside the timed function's calls."""

    def __init__(self, durations, log):
        self.ticks = []
        now = 100.0
        for d in durations:
            self.ticks += [now, now + d]
            now += d + 1.0
        self.ticks.reverse()
        self.log = log

    def __call__(self):
        self.log.append("clock")
        return self.ticks.pop()


@pytest.mark.parametrize("durations,rtt,want", [
    ([0.005, 0.003, 0.009, 0.004, 0.007], 0.001, 0.004),
    ([0.004, 0.002, 0.008, 0.006], 0.0005, 0.0055),     # the upper median
    ([0.004, 0.002, 0.008], 1.0, 0.0),                  # clamped at 0
])
def test_device_time_cpu(monkeypatch, durations, rtt, want):
    log = []
    monkeypatch.setattr(tprof, "perf_counter", FakeClock(durations, log))
    x = torch.arange(6, dtype=torch.float32)

    def fn(a):
        log.append("call")
        return a * 2

    got = tprof.device_time(fn, x, iters=len(durations), rtt=rtt)
    assert got == pytest.approx(want, abs=1e-12)
    # the warm-up call first and untimed, then (t0, call, t1) per iteration
    assert log == ["call"] + ["clock", "call", "clock"] * len(durations)


def test_device_time_chain_cpu(monkeypatch):
    log, seen = [], []
    durations = [0.064, 0.048, 0.080]
    monkeypatch.setattr(tprof, "perf_counter", FakeClock(durations, log))
    x = torch.ones(4)

    def perturb(args, i):
        assert i.shape == () and i.dtype == torch.float32
        seen.append(float(i))
        return (args[0] + i,)

    def fn(a):
        log.append("call")
        return a

    got = tprof.device_time_chain(fn, x, perturb=perturb, reps=16, iters=3,
                                  rtt=0.016)
    assert got == pytest.approx((0.048 - 0.016) / 16, abs=1e-12)
    assert seen == list(range(16)) * 4
    assert log == ["call"] * 16 + (["clock"] + ["call"] * 16
                                   + ["clock"]) * 3
    monkeypatch.setattr(tprof, "perf_counter", FakeClock(durations, []))
    assert tprof.device_time_chain(fn, x, perturb=perturb, reps=16,
                                   iters=3, rtt=1.0) == 0.0


@dataclasses.dataclass
class Out:
    a: torch.Tensor
    meta: str
    b: dict


class Pair(NamedTuple):
    img: torch.Tensor
    rng: torch.Tensor


def test_every_leaf_reduced():
    out = (torch.full((2, 3), 1.5), [Pair(torch.ones(4, dtype=torch.uint8)
                                          * 250, torch.arange(3.0))],
           {"d": Out(torch.tensor([2.0, -1.0]), "not a tensor",
                     {"e": torch.tensor(7, dtype=torch.int64)})}, 3.0)
    leaves = tprof._tensors(out)
    assert len(leaves) == 5
    s = tprof._reduced(out, torch.device("cpu"))
    assert s.dtype == torch.float32 and s.shape == ()
    assert float(s) == 9.0 + 1000.0 + 3.0 + 1.0 + 7.0
    calls = []
    tprof.device_time(lambda a: calls.append(1) or out, torch.ones(1),
                      iters=2, rtt=0.0)
    assert len(calls) == 3


def test_devices_from_args():
    x = torch.ones(2)
    assert tprof._device_of((x, Pair(x, x), {"k": [x]})).type == "cpu"
    assert tprof._device_of((1, "no tensors")).type == "cuda"
    with pytest.raises(ValueError, match="several devices"):
        tprof.device_time(lambda a, b: a, x, torch.ones(2, device="meta"))
    assert tprof.measure_rtt(iters=3, device="cpu") >= 0.0
    assert tprof.device_time(lambda a: a @ a, torch.ones(16, 16),
                             iters=3) >= 0.0


def test_import_loads_no_jax(tmp_path):
    code = ("import sys\nimport horizonator_tpu_torch.profiling as p\n"
            "assert 'jax' not in sys.modules\n"
            "assert {'PhaseTimer', 'phase', 'report', 'device_time', "
            "'device_time_chain', 'measure_rtt'} <= set(dir(p))\nprint('ok')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


EMPTY = {"spans": {}, "roots": (0, 0.0), "counters": {}}


def test_spans_off_record_nothing(monkeypatch):
    """No profiler: the shared no-op, no clock read, nothing recorded."""
    tprof.reset()
    monkeypatch.setattr(tprof, "perf_counter", lambda: 1 / 0)
    assert tprof.phase("hz.a") is tprof._NOOP
    assert tprof.sync() is tprof._NOOP
    with tprof.phase("hz.a"), tprof.sync():
        tprof.count("hz.n", 3)
    assert tprof.snapshot() == EMPTY
    assert tprof.report() == ""


def _hz_events(prof):
    """{(nearest hz. ancestor or None, name)} of the hz. spans in a
    profile, and whether each is a user annotation."""
    edges, flags = set(), set()
    for e in prof.events():
        if e.name.startswith("hz.") and e.device_type.name == "CPU":
            p = e.cpu_parent
            while p is not None and not p.name.startswith("hz."):
                p = p.cpu_parent
            edges.add((p and p.name, e.name))
            flags.add(e.is_user_annotation)
    assert flags == {True}
    return edges


def test_spans_under_profiler(monkeypatch):
    tprof.reset()
    clock = iter([0.0, 1.0, 1.5, 3.0, 4.0, 10.0, 20.0, 21.0])
    monkeypatch.setattr(tprof, "perf_counter", lambda: next(clock))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.phase("hz.a"):
            with tprof.phase("hz.b"):
                tprof.count("hz.n", 3)
            with tprof.sync():
                torch.ones(4).sum()
        with tprof.phase("hz.a"):
            tprof.count("hz.n")
    with tprof.phase("hz.c"):           # the profiler has stopped
        tprof.count("hz.n", 5)
    assert _hz_events(prof) == {(None, "hz.a"), ("hz.a", "hz.b"),
                                ("hz.a", "hz.sync")}
    assert tprof.snapshot() == {
        "spans": {"hz.b": (1, 0.5, 0.5), "hz.sync": (1, 1.0, 1.0),
                  "hz.a": (2, 11.0, 9.5)},
        "roots": (2, 11.0),
        "counters": {"hz.n": (4, 2), "hz.host_syncs": (1, 1)}}
    assert tprof.report().startswith("hz.a")
    tprof.reset()
    assert tprof.snapshot() == EMPTY


def _recorded(fn):
    """(hz. span edges, snapshot) of ``fn()`` under torch.profiler."""
    tprof.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    snap = tprof.snapshot()
    tprof.reset()
    return _hz_events(prof), snap


RENDER_TREE = {
    (None, "hz.api.render"), ("hz.api.render", "hz.api.plan"),
    ("hz.api.plan", "hz.render.make_params"),
    ("hz.render.make_params", "hz.sync"),
    ("hz.api.render", "hz.render.geometry"),
    ("hz.api.render", "hz.render.march"),
    ("hz.render.march", "hz.kernels.march"),
    ("hz.render.march", "hz.render.near_band"),
    ("hz.api.render", "hz.render.resolve"),
    ("hz.render.resolve", "hz.render.row_map"),
    ("hz.render.resolve", "hz.kernels.resolve"),
    ("hz.render.resolve", "hz.render.tail"),
    ("hz.api.render", "hz.api.readback"), ("hz.api.readback", "hz.sync"),
    ("hz.api.render", "hz.api.guard")}


def _hill(lat, lon):
    return np.round(300.0 + 900.0 * np.exp(
        -((lat - 34.6) ** 2 + (lon + 117.4) ** 2) / 0.001))


def test_render_span_tree(synthetic_dem_dir):
    """A render's spans: the plan (the params' upload), geometry, march
    (near band, launch), resolve (row map, launch, tail), readback (the
    outputs and the guard's counts behind one sync) and guard (no copy of
    its own): two syncs."""
    from horizonator_tpu_torch import horizonator
    h = horizonator(34.55, -117.5, 48, 16, render_radius_cells=64,
                    dir_dems=synthetic_dem_dir({(34, -118): _hill}),
                    device="cpu")
    edges, snap = _recorded(lambda: h.render(-180, 180, zfar=5000.0))
    assert edges == RENDER_TREE
    spans = snap["spans"]
    assert snap["roots"] == (1, spans["hz.api.render"][1])
    assert {k: v[0] for k, v in spans.items()} == dict(
        {name: 1 for _, name in RENDER_TREE}, **{"hz.sync": 2})
    assert snap["counters"] == {"hz.host_syncs": (2, 2),
                                "hz.viewpoints": (1, 1)}
    for n, total, own in spans.values():
        assert 0.0 <= own <= total


def _tile_cache(root, lat, lon, radius):
    """Seeded flat-coloured z12 tiles over build_atlas' range for a
    viewer at (lat, lon), written by the port's own PNG encoder; returns
    the number of tiles."""
    from horizonator_tpu_torch._png import encode_png
    from horizonator_tpu_torch.render.texture import tile_xy_from_latlon
    r = radius / 1200
    x_lo, y_lo = tile_xy_from_latlon(lat + r, lon - r, 12)
    x_hi, y_hi = tile_xy_from_latlon(lat - r, lon + r, 12)
    g = np.random.default_rng(7)
    for x in range(x_lo, x_hi + 1):
        for y in range(y_lo, y_hi + 1):
            p = root / "mapnik" / "12" / str(x) / f"{y}.png"
            p.parent.mkdir(parents=True, exist_ok=True)
            rgb = np.broadcast_to(g.integers(0, 256, 3, dtype=np.uint8),
                                  (256, 256, 3))
            p.write_bytes(encode_png(np.ascontiguousarray(rgb)))
    return (x_hi - x_lo + 1) * (y_hi - y_lo + 1)


TEXTURED_TREE = RENDER_TREE | {
    ("hz.render.near_band", "hz.render.near_colors"),
    ("hz.render.march", "hz.render.hybrid")}


@pytest.mark.parametrize("exact_near_m", [1200.0, 20000.0])
def test_textured_spans(synthetic_dem_dir, tmp_path, exact_near_m):
    """The textured API: under the profiler the constructor records the
    atlas (its tiles decoded) and the colour planes, a render the near
    band's colours and the hybrid near field (one render counted) with
    the untextured render's two syncs; without it, nothing. Past the
    near field's cap (20 km) a render counts its fallback instead."""
    from horizonator_tpu_torch import horizonator
    n_tiles = _tile_cache(tmp_path / "tiles", 34.55, -117.5, 64)
    dems = synthetic_dem_dir({(34, -118): _hill})

    def build():
        return horizonator(34.55, -117.5, 48, 16, render_radius_cells=64,
                           dir_dems=dems, device="cpu", render_texture=True,
                           dir_tiles=str(tmp_path / "tiles"),
                           allow_downloads=False, exact_near_m=exact_near_m)

    def render():
        return h.render(-180, 180, zfar=5000.0)

    tprof.reset()
    h = build()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        render()
    assert tprof.snapshot() == EMPTY
    edges, snap = _recorded(build)
    assert edges == {(None, "hz.tiles.atlas"), (None, "hz.texture.planes")}
    assert snap["counters"] == {"hz.tiles.decoded": (n_tiles, 1)}
    hybrid = exact_near_m <= 1200.0
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        edges, snap = _recorded(render)
    assert any("hybrid near-field" in str(w.message)
               for w in seen) == (not hybrid)
    assert edges == TEXTURED_TREE
    assert {k: v[0] for k, v in snap["spans"].items()} == dict(
        {name: 1 for _, name in TEXTURED_TREE}, **{"hz.sync": 2})
    counter = "hz.texture.hybrid" + ("" if hybrid else "_fallback")
    assert snap["counters"] == {"hz.host_syncs": (2, 2),
                                "hz.viewpoints": (1, 1), counter: (1, 1)}


def _ridge(n=256):
    z = np.zeros((n, n), np.float32)
    z[150:152, :] = 300.0
    return z


@pytest.mark.parametrize("entry", ["viewshed_count", "viewshed_sweep"])
def test_viewshed_span_trees(entry):
    """viewshed_count: the prep (the viewpoints' upload), per batch the
    march and the resampler's one call (``resample``, which adds the batch
    into the count), as on a card; viewshed_sweep: the prep and a march a
    batch. A numpy grid's upload is one sync more."""
    from horizonator_tpu_torch import ops
    pts = np.array([[120.0, 120.0], [130.0, 110.0], [128.0, 136.0]])
    kw = dict(width=64, nsteps=128, cells_per_deg=1200, znear=50.0,
              zfar=3000.0, batch=2, sampler="window", device="cpu")
    march = {("hz.viewshed.march", "hz.kernels.march"),
             ("hz.viewshed.march", "hz.render.near_band")}
    if entry == "viewshed_count":
        kw.update(out_center_ij=(128.0, 128.0), out_halfwidth=16)
        root = "hz.ops.viewshed_count"
        tree = march | {
            (root, "hz.ops.viewshed_grid"),
            ("hz.ops.viewshed_grid", "hz.viewshed.march"),
            ("hz.ops.viewshed_grid", "hz.viewshed.resample"),
            ("hz.viewshed.resample", "hz.kernels.resample")}
        syncs = 1                     # the viewpoints
    else:
        root = "hz.ops.viewshed_sweep"
        tree = march | {(root, "hz.viewshed.march")}
        syncs = 1
    tree |= {(None, root), (root, "hz.ops.sweep_prep"),
             ("hz.ops.sweep_prep", "hz.sync")}
    fn = getattr(ops, entry)
    for dem, extra in ((torch.from_numpy(_ridge()), 0), (_ridge(), 1)):
        edges, snap = _recorded(lambda: fn(dem, pts, **kw))
        assert edges == tree
        assert snap["counters"] == {"hz.host_syncs": (syncs + extra,) * 2,
                                    "hz.viewpoints": (3, 1)}
        assert snap["roots"] == (1, snap["spans"][root][1])
        assert snap["spans"]["hz.viewshed.march"][0] == 2


@pytest.mark.parametrize("shapes", [[(2,)], [(3, 5, 4), (3, 5), (3, 2)]])
def test_to_host_cpu_shares_memory(shapes):
    """The API's readback of CPU tensors: each array is the tensor's own
    ``.numpy()`` (shared memory, no copy), behind one recorded sync and
    no pinned-readback count."""
    from horizonator_tpu_torch.api import _to_host
    g = torch.Generator().manual_seed(3)
    ts = [torch.randint(0, 255, s, generator=g, dtype=dt)
          for s, dt in zip(shapes, (torch.uint8, torch.float32, torch.int32))]
    edges, snap = _recorded(lambda: _to_host(*ts))
    out = _to_host(*ts)
    assert len(out) == len(ts)
    for a, t in zip(out, ts):
        assert isinstance(a, np.ndarray) and np.shares_memory(a, t.numpy())
        np.testing.assert_array_equal(a, t.numpy())
    assert edges == {(None, "hz.sync")}
    assert snap["counters"] == {"hz.host_syncs": (1, 1)}


def _guard_says(guard, strict, sampler, what):
    """(warning texts, error text) of ``_check_dropped(guard)`` on a bare
    instance."""
    from horizonator_tpu_torch import horizonator
    h = object.__new__(horizonator)
    h.strict_coverage = strict
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            h._check_dropped(guard, what, sampler=sampler)
            err = None
        except RuntimeError as e:
            err = str(e)
    return [str(w.message) for w in seen], err


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("counts,sampler,what", [
    ([0, 0], "window", "render"), ([3, 0], "window", "render"),
    ([0, 5], "lod", "render"), ([3, 5], "window", "render"),
    ([[0, 0], [0, 7], [2, 0]], "window", "render_batch"),
    ([[0, 0], [0, 0]], "window", "render_batch")])
def test_check_dropped_host_counts(counts, sampler, what, strict):
    """The coverage guard given the host's counts (numpy, as the readback
    hands them over) warns and raises word for word as given the same
    counts as a tensor, (2,) and (B, 2); the tensor takes one sync, the
    host's counts none."""
    host = np.asarray(counts, dtype=np.int32)
    dev = torch.from_numpy(host.copy())
    syncs = []
    for guard in (host, dev):
        tprof.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            said = _guard_says(guard, strict, sampler, what)
        syncs.append(tprof.snapshot()["counters"])
        tprof.reset()
        assert said == _guard_says(host, strict, sampler, what)
    assert syncs == [{}, {"hz.host_syncs": (1, 1)}]
    warned, err = said
    assert (warned or err) if host.any() else not (warned or err)
    assert bool(err) == (strict and bool(host.any()))
    if host.ndim == 2 and host.any():
        assert "(viewpoints [1, 2] of 3)" in (err or warned[0])


def _pinned_pct():
    from portbench import harness
    from portbench.loader import load_module
    return load_module(harness.HERE / "metrics"
                       / "pinned_readback_pct.view.py").read(None)


@pytest.mark.parametrize("renders,pinned,want", [
    (0, 0, None), (1, 0, 0.0), (2, 1, 50.0), (3, 3, 100.0)])
def test_pinned_readback_pct_metric(renders, pinned, want):
    """``pinned_readback_pct.view``: the counter over the renders, in %;
    None where nothing rendered, 0 where the counter is absent."""
    tprof.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(renders):
            with tprof.phase("hz.api.render"):
                if i < pinned:
                    tprof.count("hz.api.pinned_readback")
    try:
        assert _pinned_pct() == want
    finally:
        tprof.reset()


def test_pinned_readback_pct_cpu_run():
    """A tiny traced pano-single run on the CPU: correct, its renders read
    back without page-locked memory, so the metric reads 0."""
    from portbench import harness
    from portbench.conftest import tiny_files
    cell = "srtm3-40km.pano-single"
    tprof.reset()
    out, _ = harness.run_cell(cell, 2 ** 31 + 13, 0.2, True, device="cpu",
                              files=tiny_files(cell))
    tprof.reset()
    assert out["correct"]
    assert out["metrics"]["pinned_readback_pct.view"]["value"] == 0.0
    assert out["metrics"]["host_syncs.view"]["value"] == 2.0
