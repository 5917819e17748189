"""Per-stage ceiling probe for a merge-based resolve, on the card.

The counterpart of the JAX package's ``benchmarks/profile_roll_ceiling.py``
(its ``run`` and ``main``). It times S stages of a circular roll + compare-
exchange over a (W, m) int32 array, through the port's
``kernels/csrc/roll_ceiling.cu``:

- ``minmax``: one partner + min or max per stage (a bitonic merge's or a
  bracket scan's stage);
- ``kv``: the same on a key array with a value array following the key's
  exchanges (a textured merge's stage).

Rows of m = 32 R lanes with R in the source's set (the default m 1664 is
R 52) run on the register kernels, a warp per row; other m on the
shared-memory kernels (``kernels/roll_ceiling.py``).

Prints ms per call and G elem-stages/s (elem = one lane of one row of ONE
array, so kv counts 2 arrays), then the implied resolve floor at 45
stages. That floor is the ceiling a merge-based resolve of m lanes would be
held against; the port's resolve is a scan, a scatter and a second scan,
not a merge, so the script prints its measured time beside the floor.

Times come from CUDA events around a back-to-back run of ``reps`` calls,
each on a perturbed input (x + i), after a warm-up. Needs a CUDA card:

    python -m horizonator_tpu_torch.benchmarks.profile_roll_ceiling [m] [stages]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels.resolve import resolve
from ..kernels.roll_ceiling import roll_kv, roll_minmax
from ..render.resolve_window import alpha_quantum

W = 4096
RESOLVE_K = 580          # the bench render's samples per column (576 + 4)
RESOLVE_H = 1024
FLOOR_STAGES = 45


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_ms(fn, args, warmup=2):
    """Mean device ms of fn(*args[i]) over a back-to-back run, CUDA events
    around the run."""
    for i in range(warmup):
        fn(*args[i % len(args)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for a in args:
        fn(*a)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / len(args)


def probe_input(w: int, m: int, device="cuda") -> torch.Tensor:
    """The JAX probe's input: arange(W*m) % 2**20 as (W, m) int32."""
    return (torch.arange(w * m, dtype=torch.int32, device=device)
            .reshape(w, m) % (1 << 20))


def run(flavor: str, w: int, m: int, stages: int, reps: int = 16):
    """(elem-stages per second, ms per call) of one flavor."""
    x = probe_input(w, m)
    if flavor == "minmax":
        args = [(x + i, stages) for i in range(reps)]
        ms = run_ms(roll_minmax, args)
        arrs = 1
    else:
        args = [(x + i, x + i + 1, stages) for i in range(reps)]
        ms = run_ms(roll_kv, args)
        arrs = 2
    eps = w * m * stages * arrs / (ms * 1e-3)
    log(f"{flavor:7s} W={w} m={m} S={stages}: {ms:.4f} ms "
        f"-> {eps / 1e9:.0f} G elem-stages/s")
    return eps, ms


def resolve_ms(w=W, k=RESOLVE_K, height=RESOLVE_H, reps=16, seed=0):
    """The port's resolve kernel on seeded rows at the bench shape."""
    y = torch.from_numpy(np.random.default_rng(seed).uniform(
        -64.0, height + 64.0, (w, k)).astype(np.float32)).cuda()
    amax, int_first = alpha_quantum(k, height)
    return run_ms(resolve, [(y, height, amax, int_first)] * reps)


def floor_lines(eps_minmax, eps_kv, w, m, resolve_time_ms):
    """The implied floors of a 45-stage merge over m lanes, beside the
    port's measured resolve."""
    out = []
    for name, eps, narr in (("untextured", eps_minmax, 1),
                            ("textured", eps_kv, 2)):
        floor_ms = w * m * FLOOR_STAGES * narr / eps * 1e3
        out.append(f"implied {name} resolve floor at {FLOOR_STAGES} stages: "
                   f"{floor_ms:.4f} ms (the ceiling a merge-based resolve "
                   f"over m={m} lanes would be held against)")
    out.append(f"the port's resolve (scans and a scatter, no merge; W={w} "
               f"K={RESOLVE_K} H={RESOLVE_H}): {resolve_time_ms:.4f} ms "
               f"measured")
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        log("profile_roll_ceiling: needs a CUDA card")
        return 2
    log(f"device: {torch.cuda.get_device_name(0)}")
    m = int(args[0]) if len(args) > 0 else 1664
    stages = int(args[1]) if len(args) > 1 else 40
    e1, _ = run("minmax", W, m, stages)
    e2, _ = run("kv", W, m, stages)
    for line in floor_lines(e1, e2, W, m, resolve_ms()):
        log(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
