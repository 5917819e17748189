"""The benchmark's harness: one cell, one seed, one process.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``'s ``workloads``, its configuration's file from
``configs``, its traffic mix in ``traffic/<traffic>.json`` (its
viewpoints drawn by ``kinds/<kind>.py``), the entry that the mix drives in
``drivers/<entry>.py``, its correctness limits in
``limits/<cell>.json``, each end-to-end metric's reader in
``e2e/<metric>.py`` and each per-layer metric's in ``metrics/<metric>.py``.

A run: set-up (the seeded inputs, the program's objects, a few warm-up
requests of the cell's shapes), then the closed loop for ``seconds`` (or,
traced, for the mix's ``trace_seconds`` under torch.profiler), then the
check: a sample of the window's requests, drawn from the seed, against the
plain reference, run after the program's state is freed.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

from .loader import load_module
from .terrain import rng
from .traffic import Requests

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "horizonator_tpu")


def manifest(path: Path | None = None) -> dict:
    return json.loads((path or REPO / "BENCHMARK.json").read_text())


def resolve(cell_name: str, man: dict, repo: Path = REPO) -> dict:
    """The files and metrics of a cell, found by name under ``repo``."""
    here = repo / HERE.name
    cells = {w["name"]: w for w in man["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    cfg = {c["name"]: c for c in man["configs"]}[cell["config"]]
    mix_path = here / "traffic" / f"{cell['traffic']}.json"
    mix = json.loads(mix_path.read_text())

    def applies(m):
        return cell_name in m.get("workloads", [cell_name])
    return dict(
        cell=cell,
        config=json.loads((repo / cfg["file"]).read_text()),
        mix=mix,
        driver=here / "drivers" / f"{mix['entry']}.py",
        kinds=here / "kinds",
        limits=json.loads((here / "limits" / f"{cell_name}.json")
                          .read_text()),
        end_to_end=[(m, here / "e2e" / f"{m['name']}.py")
                    for m in man["end_to_end"] if applies(m)],
        per_layer=[(m, here / "metrics" / f"{m['name']}.py")
                   for m in man["per_layer"] if applies(m)])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class Window:
    """What the closed loop measured."""

    def __init__(self):
        self.latencies, self.kept, self.traced = [], [], []
        self.requests = self.failed = self.viewpoints = 0
        self.errors = []
        self.window_s = self.setup_s = 0.0


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _loop(ctx, driver, state, gen, seconds, keep_n):
    """The closed loop: the next request as soon as the last returned; each
    in a ``pb.request`` span when traced."""
    w = Window()
    traced = ctx.span is not _nospan
    pick = rng(ctx.seed, 3)
    n_ok = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_end = t_start
    while time.perf_counter() < deadline:
        req = gen.next()
        t0 = time.perf_counter()
        try:
            with ctx.span("pb.request"):
                out = driver.request(ctx, state, req)
        except Exception as e:           # a failed request counts, as such
            out = None
            w.failed += 1
            if len(w.errors) < 3:
                w.errors.append(f"{type(e).__name__}: {e}")
        t_end = time.perf_counter()
        w.latencies.append(t_end - t0)
        w.requests += 1
        if out is None:
            continue
        w.viewpoints += driver.viewpoints(ctx, req)
        if traced:
            w.traced.append(req)
        n_ok += 1
        if len(w.kept) < keep_n:
            w.kept.append((req, out))
        else:
            j = int(pick.integers(n_ok))
            if j < keep_n:
                w.kept[j] = (req, out)
    w.window_s = t_end - t_start
    return w


def check(ctx, driver, kept, limits, dtype=None):
    """{name: (value, limit)} over the kept requests: each number the worst
    over them; the program's outputs against the reference's, or, with
    ``dtype``, the reference in that precision in the program's place."""
    import torch
    worst = {}
    for req, out in kept:
        ref = driver.reference(ctx, req, torch.float32)
        if dtype is not None:
            out = driver.reference(ctx, req, dtype)
        for name, v in driver.compare(out, ref).items():
            worst[name] = max(worst.get(name, -math.inf), v)
        del ref, out
    return {name: (worst.get(name, math.nan), lim["limit"])
            for name, lim in limits.items()}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", files: dict | None = None,
             t_process: float | None = None, setup_hook=None,
             control_dtype=None):
    """One run of a cell: the result dict the command prints. ``files``
    replaces what ``resolve`` finds (tests use small sizes);
    ``setup_hook(ctx, state)`` runs after set-up (tests plant faults).
    With ``control_dtype``, the check's control: the reference in that
    precision stands in the program's place for the outputs the window
    kept, and decides ``correct``; the program's own readings of the same
    outputs go under ``program_check``."""
    import torch
    t_process = time.perf_counter() if t_process is None else t_process
    f = files or resolve(cell_name, manifest())
    driver = load_module(f["driver"])
    dev = torch.device(device)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    ctx = types.SimpleNamespace(config=f["config"], mix=f["mix"], seed=seed,
                                device=dev, tmp=tmp, inputs={},
                                span=_nospan, kinds=f["kinds"])
    try:
        state = driver.setup(ctx)
        if setup_hook is not None:
            setup_hook(ctx, state)
        warm = _warm_up(ctx, driver, state)
        gen = Requests(ctx.mix, ctx.config, seed, kinds=ctx.kinds)
        keep_n = ctx.mix["check_requests"]
        if trace:
            w, prof = _traced(ctx, driver, state, gen, seconds, keep_n, warm)
        else:
            _sync(dev)
            setup_s = time.perf_counter() - t_process
            w = _loop(ctx, driver, state, gen, seconds, keep_n)
            w.setup_s = setup_s
        _sync(dev)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        del state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if trace:
            tr = _reduce(ctx, driver, w, prof)
            del prof
        checks = check(ctx, driver, w.kept, f["limits"])
        if control_dtype is not None:
            program = checks
            checks = check(ctx, driver, w.kept, f["limits"],
                           dtype=control_dtype)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct = bool(w.kept) and all(v <= lim for v, lim in checks.values())
    metrics = {}
    if trace:
        for m, path in f["per_layer"]:
            v = load_module(path).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m, path in f["end_to_end"]:
            metrics[m["name"]] = {"value": load_module(path).read(w),
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": f["cell"]["chips"],
                   "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": w.requests, "failed": w.failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    if control_dtype is not None:
        out["program_check"] = {k: v for k, (v, _) in program.items()}
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in checks.items()}
    return out, w


def _warm_up(ctx, driver, state) -> Requests:
    """The mix's ``warm_requests`` requests of its own shapes, then more
    until ``warm_seconds`` have passed (the first seconds of a loop run
    slower: allocators, caches and clocks settle); from a stream of their
    own, so the window's requests are the same whatever the warm-up ran.
    Returns the warm-up's generator."""
    warm = Requests(ctx.mix, ctx.config, ctx.seed, stream=2,
                    kinds=ctx.kinds)
    t_end = time.perf_counter() + ctx.mix.get("warm_seconds", 0.0)
    for i in itertools.count():
        if i >= ctx.mix["warm_requests"] and time.perf_counter() >= t_end:
            return warm
        driver.request(ctx, state, warm.next())


def _nospan(name):
    return contextlib.nullcontext()


def _traced(ctx, driver, state, gen, seconds, keep_n, warm):
    """The traced window: the loop under torch.profiler, after one traced
    warm-up request so that the profiler's own start-up is outside it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        driver.request(ctx, state, warm.next())
        _sync(ctx.device)
    ctx.span = record_function
    span_s = min(seconds, ctx.mix["trace_seconds"])
    with profile(activities=acts) as prof:
        w = _loop(ctx, driver, state, gen, span_s, keep_n)
        _sync(ctx.device)
    ctx.span = _nospan
    return w, prof


def _reduce(ctx, driver, w, prof):
    """The traced window's Trace, with the least work of its requests."""
    from .trace import Trace
    work = {}
    for req in w.traced:
        for k, v in driver.work(ctx, req).items():
            work[k] = work.get(k, 0.0) + v
    return Trace(prof.events(), w.requests - w.failed, w.viewpoints, work)


def check_lines(out: dict) -> list[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in out["check"].items()]


def main(argv=None, t_process=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bfloat16",),
                    help="the check's control: the reference in this "
                         "precision in the program's place (never part of "
                         "a benchmark run)")
    args = ap.parse_args(argv)
    f = resolve(args.workload, manifest())
    import torch
    chips = f["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{power_limit()}", file=sys.stderr)
    control = getattr(torch, args.control) if args.control else None
    out, w = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), files=f, t_process=t_process,
                      control_dtype=control)
    for e in w.errors:
        print(f"portbench: failed request: {e}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for line in check_lines(out):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
