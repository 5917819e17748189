"""Phase timing + device profiling helpers.

The port of horizonator_tpu.profiling. The reference's only instrumentation
is a dead rdtsc macro (bench.h, included but never called -- SURVEY.md
§5.1). Here timing is a real subsystem:

- ``phase(name)``: wall-clock context manager that also opens a
  ``torch.profiler.record_function`` range, so phases show up in
  torch.profiler tables and traces;
- ``PhaseTimer``: accumulates named phase durations (init/upload/render/
  readback -- "ms/viewpoint" being the framework's north-star metric);
- ``device_time(fn, *args)`` and ``device_time_chain``: the time of a call
  on the device of its tensor arguments. On a CUDA device, CUDA events on
  the current stream bracket the calls, so no host pull lies in the timed
  window and nothing is subtracted; on the CPU, the host clock brackets the
  call and a scalar pull, and the measured pull (``measure_rtt``) is
  subtracted, as the JAX module does for its transport.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from time import perf_counter

import torch


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = perf_counter()
        with torch.profiler.record_function(name):
            yield
        dt = perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:24s} {tot * 1e3:9.2f} ms total "
                         f"({n}x, {tot / n * 1e3:.2f} ms avg)")
        return "\n".join(lines)


_global_timer = PhaseTimer()


def phase(name: str):
    """Module-level phase context: ``with profiling.phase("render"): ...``"""
    return _global_timer.phase(name)


def report() -> str:
    return _global_timer.report()


def _tensors(tree) -> list:
    """The tensor leaves of nested tuples (NamedTuples too), lists, dicts
    and dataclass instances; other leaves are dropped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for sub in tree for t in _tensors(sub)]


def _device_of(args) -> torch.device:
    """The one device of the tensors in ``args`` ("cuda" when there are
    none, the port's default); mixed devices raise."""
    devs = {t.device for t in _tensors(args)}
    if len(devs) > 1:
        raise ValueError(f"arguments on several devices: "
                         f"{sorted(map(str, devs))}")
    return devs.pop() if devs else torch.device("cuda")


def _reduced(out, dev: torch.device) -> torch.Tensor:
    """Every tensor leaf of ``out`` summed in float32, then summed: one 0-d
    tensor whose value needs all of the output."""
    s = torch.zeros((), dtype=torch.float32, device=dev)
    for leaf in _tensors(out):
        s = s + leaf.to(torch.float32).sum()
    return s


def _cuda_seconds(dev: torch.device, call) -> float:
    """Seconds between two CUDA events on ``dev``'s current stream around
    ``call()``; the host waits for the second event, pulls nothing."""
    stream = torch.cuda.current_stream(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    call()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def device_time_chain(fn, *args, perturb, reps: int = 16, iters: int = 5,
                      rtt: float | None = None):
    """MIN seconds per call of fn, timed as chains of ``reps``
    sequentially-issued perturbed calls per timed window.

    For workloads comparable to or smaller than the launch and pull cost,
    the single-call ``device_time`` drowns in that noise; chaining amortizes
    it by ``reps``. ``perturb(args, i)`` must return fresh call args per
    chain element (e.g. a moved camera), with ``i`` a 0-d float32 tensor
    0..reps-1 on the args' device. The chain's reduced outputs are summed
    and, on the CPU, pulled once; on a CUDA device CUDA events bracket the
    chain and ``rtt`` is not used.
    """
    dev = _device_of(args)
    idx = torch.arange(reps, dtype=torch.float32, device=dev)

    def chain():
        s = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(reps):
            s = s + _reduced(fn(*perturb(args, idx[i])), dev)
        return s

    chain().item()
    ts = []
    if dev.type == "cuda":
        for _ in range(iters):
            ts.append(_cuda_seconds(dev, chain))
        return min(ts) / reps
    if rtt is None:
        rtt = measure_rtt(device=dev)
    for _ in range(iters):
        t0 = perf_counter()
        chain().item()
        ts.append(perf_counter() - t0)
    # min, same rationale as measure_rtt: jitter only ever inflates a
    # sample, so the fastest chain is the honest time
    return max(0.0, min(ts) - rtt) / reps


def measure_rtt(iters: int = 8, device="cuda") -> float:
    """MINIMUM seconds of a fresh 0-d tensor's pull (``.item()``) on
    ``device``.

    The min, not the median: jitter only ever inflates a sample, so the min
    is the true floor, and subtracting it is the conservative direction --
    every timing that subtracts this can only OVERestimate the measured
    workload.
    """
    x = torch.tensor(1.0, dtype=torch.float32, device=device) * 2
    x.item()
    ts = []
    for _ in range(iters):
        t0 = perf_counter()
        (x + 0 * perf_counter()).item()        # fresh value, forces a pull
        ts.append(perf_counter() - t0)
    return min(ts)


def device_time(fn, *args, iters: int = 5, rtt: float | None = None):
    """Median seconds per call of fn(*args), each call's output reduced to
    a float32 scalar inside the timed window, after one untimed call.

    On a CUDA device CUDA events on the current stream bracket each call and
    its reduction: no pull lies in that window, so ``rtt`` is not used. On
    the CPU the host clock brackets the call and the scalar's pull, and the
    pull's cost (``rtt``, measured when None) is subtracted. The median is
    the upper one, ``ts[len(ts) // 2]``.
    """
    dev = _device_of(args)
    _reduced(fn(*args), dev).item()
    ts = []
    if dev.type == "cuda":
        for _ in range(iters):
            ts.append(_cuda_seconds(dev, lambda: _reduced(fn(*args), dev)))
        ts.sort()
        return ts[len(ts) // 2]
    if rtt is None:
        rtt = measure_rtt(device=dev)
    for _ in range(iters):
        t0 = perf_counter()
        _reduced(fn(*args), dev).item()
        ts.append(perf_counter() - t0)
    ts.sort()
    return max(0.0, ts[len(ts) // 2] - rtt)
