"""Port parity for profiling.py: ``PhaseTimer`` / ``phase`` / ``report``
against horizonator_tpu.profiling (its report string equal on the same
recorded phases, ties included), the phase ranges in torch.profiler, and
``device_time`` / ``device_time_chain`` on CPU tensors with a fake
``perf_counter`` in the port's module (the statistic, the clamp after the
pull's cost, the untimed warm-up, ``perturb``'s indices, the reduced
leaves). Importing the module loads no JAX.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import pytest
import torch

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
    monkeypatch.setattr(tprof, "_global_timer", tprof.PhaseTimer())
    clock = iter([0.0, 0.002])
    with tprof.phase("probe"):
        pass
    assert tprof._global_timer.counts["probe"] == 1
    assert tprof.report() == tprof._global_timer.report()
    assert tprof.report().startswith("probe") and "2.00 ms total" in \
        tprof.report()


def test_phase_in_torch_profiler():
    from torch.profiler import ProfilerActivity, profile
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
