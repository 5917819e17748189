"""Phase timing, spans and counters, and device profiling helpers.

The port of horizonator_tpu.profiling. The reference's only instrumentation
is a dead rdtsc macro (bench.h, included but never called -- SURVEY.md
§5.1). Here timing is a real subsystem:

- ``phase(name)``: a span of the program. It records only while
  torch.profiler runs (``torch.autograd.profiler._is_profiler_enabled``);
  otherwise it returns one shared no-op context, so a span on the hot path
  costs a flag check. Recorded, it opens a ``record_function`` range (the
  span on the profiler's timeline) and sums its host time into the
  module's ``PhaseTimer``: count, total and self time (total less the
  spans opened inside it, on the same thread), and the root spans' count
  and total;
- ``count(name, n=1)``: a counter, gated and summed the same way;
- ``sync()``: the span ``hz.sync`` plus one ``hz.host_syncs``, around a
  statement where the host waits for the device (a device-to-host copy, a
  scalar read, a pageable host-to-device copy);
- ``snapshot()`` and ``reset()``: what the spans and counters recorded,
  and a fresh start;
- ``PhaseTimer``: accumulates named phase durations (init/upload/render/
  readback -- "ms/viewpoint" being the framework's north-star metric); its
  own ``phase`` always records;
- ``device_time(fn, *args)`` and ``device_time_chain``: the time of a call
  on the device of its tensor arguments. On a CUDA device, CUDA events on
  the current stream bracket the calls, so no host pull lies in the timed
  window and nothing is subtracted; on the CPU, the host clock brackets the
  call and a scalar pull, and the measured pull (``measure_rtt``) is
  subtracted, as the JAX module does for its transport.

The program's spans are named ``hz.<layer>.<stage>``; PERF.md §3 lists
them with the benchmark metric each one feeds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import defaultdict
from time import perf_counter

import torch
from torch.autograd import profiler as _autograd_profiler


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        # what the module-level spans and counters add (``snapshot``)
        self.self_s = defaultdict(float)
        self.roots = [0, 0.0]
        self.sums = defaultdict(int)
        self.increments = defaultdict(int)
        self._lock = threading.Lock()

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

    def _span(self, name: str, total: float, own: float, root: bool):
        with self._lock:
            self.totals[name] += total
            self.counts[name] += 1
            self.self_s[name] += own
            if root:
                self.roots[0] += 1
                self.roots[1] += total

    def _count(self, name: str, n):
        with self._lock:
            self.sums[name] += n
            self.increments[name] += 1


_global_timer = PhaseTimer()
_NOOP = contextlib.nullcontext()
_local = threading.local()


def _open_spans() -> list:
    """This thread's stack of open recorded spans."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A span recorded while torch.profiler runs: a ``record_function``
    range, and its host time summed into the module's timer on exit."""

    __slots__ = ("name", "record", "t0", "inner")

    def __init__(self, name: str):
        self.name = name
        self.inner = 0.0

    def __enter__(self):
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        _open_spans().append(self)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        dt = perf_counter() - self.t0
        stack = _open_spans()
        stack.pop()
        self.record.__exit__(*exc)
        if stack:
            stack[-1].inner += dt
        _global_timer._span(self.name, dt, dt - self.inner, not stack)
        return False


def phase(name: str):
    """Module-level span: ``with profiling.phase("hz.api.render"): ...``,
    recorded only while torch.profiler runs (the module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def count(name: str, n=1):
    """Add ``n`` to counter ``name`` while torch.profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        _global_timer._count(name, n)


def sync():
    """The span ``hz.sync`` and one ``hz.host_syncs``: wrap a statement
    where the host waits for the device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    _global_timer._count("hz.host_syncs", 1)
    return _Span("hz.sync")


def snapshot() -> dict:
    """What the module-level spans and counters recorded: ``{"spans":
    {name: (count, total_s, self_s)}, "roots": (count, total_s),
    "counters": {name: (sum, increments)}}``."""
    t = _global_timer
    with t._lock:
        return {"spans": {k: (t.counts[k], t.totals[k], t.self_s[k])
                          for k in t.totals},
                "roots": tuple(t.roots),
                "counters": {k: (v, t.increments[k])
                             for k, v in t.sums.items()}}


def reset():
    """Forget every span and counter recorded so far."""
    global _global_timer
    _global_timer = PhaseTimer()


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
