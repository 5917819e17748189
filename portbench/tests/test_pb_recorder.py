"""The metrics that read the program's own recorder
(``horizonator_tpu_torch.profiling``): a tiny traced run of each cell
prints every one the cell lists, an untraced run prints none and leaves
the recorder empty; on the card, the syncs the recorder counts in one
call of each cell's entry are the ones CUDA's sync debug mode reports."""

import types
import warnings

import pytest
import torch

from horizonator_tpu_torch import profiling
from portbench import harness
from portbench.traffic import Requests

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
RECORDER = {"enqueue_host_ms.view", "sync_wait_ms.view", "host_syncs.view",
            "enqueue_host_us.batch", "sync_wait_us.batch",
            "host_syncs.batch"}


@pytest.mark.parametrize("cell", CELLS)
def test_recorder_metrics(cell, tiny):
    f = tiny(cell)
    names = {m["name"] for m, _ in f["per_layer"]} & RECORDER
    assert len(names) == 3
    profiling.reset()
    out, _ = harness.run_cell(cell, 2 ** 31 + 9, 0.2, False, device="cpu",
                              files=f)
    assert not set(out["metrics"]) & RECORDER
    assert profiling.snapshot() == {"spans": {}, "roots": (0, 0.0),
                                    "counters": {}}
    out, _ = harness.run_cell(cell, 2 ** 31 + 9, 0.2, True, device="cpu",
                              files=f)
    profiling.reset()
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items() if k in names}
    assert set(got) == names and all(v is not None and v >= 0
                                     for v in got.values())
    syncs = got.get("host_syncs.view", got.get("host_syncs.batch"))
    assert syncs >= 1


def _render_path(ctx, state, req):
    """render_path as the path60 cell calls it, less the cell's own read
    of the guard."""
    import math

    import numpy as np

    from horizonator_tpu_torch.parallel import render_path
    from horizonator_tpu_torch.render import make_params
    entry = ctx.entry
    c, m = ctx.config, ctx.mix
    vi, vj, vz, lat, az0, az1 = entry._frames(ctx, req)
    p = make_params(device=ctx.device, viewer_cell_i=list(vi),
                    viewer_cell_j=list(vj), viewer_z=vz,
                    cos_viewer_lat=[math.cos(math.radians(x)) for x in lat],
                    az_rad0=list(np.radians(az0)),
                    az_rad1=list(np.radians(az1)), znear=c["znear_m"],
                    zfar=c["zfar_m"], znear_color=c["znear_m"],
                    zfar_color=c["zfar_m"])
    return render_path(
        ctx.inputs["dem"], p, width=m["width"], height=m["height"],
        nsteps=entry._k(ctx), cells_per_deg=c["dem"]["cells_per_deg"],
        sampler="window", lat_hint_deg=c["view_latlon"][0],
        znear_hint_m=c["znear_m"], with_dropped=True)


def _cuda_syncs(call) -> int:
    """Synchronizing CUDA operations in ``call()``, by the sync debug
    mode's warnings."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in seen)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_syncs_match_cuda(cell, card, tmp_path):
    """One call of the cell's entry at the cell's own sizes: the recorder's
    ``hz.host_syncs`` equals the synchronizing operations that CUDA's sync
    debug mode reports (the cells' own synchronize() reports none)."""
    from torch.profiler import ProfilerActivity, profile
    f = harness.resolve(cell, MAN)
    mod = harness.load_module(f["driver"])
    ctx = types.SimpleNamespace(config=f["config"], mix=f["mix"], seed=31,
                                device=card, tmp=tmp_path, inputs={},
                                span=harness._nospan, kinds=f["kinds"],
                                entry=mod)
    state = mod.setup(ctx)
    req = Requests(f["mix"], f["config"], 31, kinds=f["kinds"]).next()
    call = (_render_path if f["mix"]["entry"] == "render_path"
            else mod.request)
    call(ctx, state, req)                     # builds and warms
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        n_cuda = _cuda_syncs(lambda: call(ctx, state, req))
    n_hz = profiling.snapshot()["counters"]["hz.host_syncs"][0]
    profiling.reset()
    print(f"{cell}: hz.host_syncs {n_hz}, CUDA sync debug {n_cuda}; "
          f"{torch.cuda.get_device_name(card)}")
    assert n_hz == n_cuda
