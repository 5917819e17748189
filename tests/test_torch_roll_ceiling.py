"""Port parity: the roll-ceiling probes against the JAX package's Pallas
kernels.

``benchmarks/profile_roll_ceiling.py`` (loaded by path: it is a script,
not a module of the package) builds its two ``pallas_call``s as its own
``run()`` does, here with ``interpret=True`` on the CPU, at W 128 and
tile_w 64. The port's plain versions (which its CUDA kernels equal bit for
bit on the card, chip_smoke.py phase 11) must equal them bit for bit: the
work is integer. m 416 is not a power of two and is below 512, so the
shift wraps (d % m) while the lane mask still tests d; the kv inputs
include keys drawn from 0..15, so most exchanges meet equal keys and the
value must stay.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from horizonator_tpu_torch.benchmarks import profile_roll_ceiling as tprobe
from horizonator_tpu_torch.kernels import roll_ceiling as trc

REPO = Path(__file__).resolve().parent.parent
W, TILE_W = 128, 64
SHAPES = [(m, s) for m in (256, 416) for s in (1, 10, 13)]


@functools.lru_cache(maxsize=None)
def _jax_probe():
    path = REPO / "benchmarks" / "profile_roll_ceiling.py"
    spec = importlib.util.spec_from_file_location("jax_profile_roll_ceiling",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved         # the script puts "." on sys.path
    return mod


def _pallas(flavor, m, stages):
    """The probe's pallas_call, built as its run() builds it."""
    probe = _jax_probe()
    spec = pl.BlockSpec((TILE_W, m), lambda b: (b, 0))
    out = jax.ShapeDtypeStruct((W, m), jnp.int32)
    if flavor == "minmax":
        return pl.pallas_call(probe.make_minmax(m, stages, TILE_W),
                              grid=(W // TILE_W,), in_specs=[spec],
                              out_specs=spec, out_shape=out, interpret=True)
    return pl.pallas_call(probe.make_kv(m, stages, TILE_W),
                          grid=(W // TILE_W,), in_specs=[spec, spec],
                          out_specs=(spec, spec), out_shape=(out, out),
                          interpret=True)


@pytest.mark.parametrize("m,stages", SHAPES)
def test_minmax_plain_bitwise_vs_pallas(m, stages):
    x = np.random.default_rng(m * 100 + stages).integers(
        -2 ** 31, 2 ** 31, (W, m), dtype=np.int64).astype(np.int32)
    ref = np.asarray(_pallas("minmax", m, stages)(jnp.asarray(x)))
    got = trc.roll_minmax(torch.from_numpy(x), stages)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(ref, x)


@pytest.mark.parametrize("keys", ["wide", "ties"])
@pytest.mark.parametrize("m,stages", SHAPES)
def test_kv_plain_bitwise_vs_pallas(m, stages, keys):
    rng = np.random.default_rng(m * 100 + stages)
    hi = 16 if keys == "ties" else 2 ** 31
    k = rng.integers(-hi if keys == "wide" else 0, hi, (W, m),
                     dtype=np.int64).astype(np.int32)
    v = rng.integers(0, 2 ** 30, (W, m), dtype=np.int64).astype(np.int32)
    rk, rv = (np.asarray(a) for a in
              _pallas("kv", m, stages)(jnp.asarray(k), jnp.asarray(v)))
    tk, tv = trc.roll_kv(torch.from_numpy(k), torch.from_numpy(v), stages)
    np.testing.assert_array_equal(tk.numpy(), rk)
    np.testing.assert_array_equal(tv.numpy(), rv)
    moved = rv != v
    assert 0.0 < moved.mean() < 1.0     # values moved, and ties kept some


def test_wrappers_route_and_check():
    """CPU tensors take the plain versions and launch nothing; any other
    device goes to the kernel's checks (no silent fallback)."""
    x = tprobe.probe_input(4, 96, device="cpu")
    n0, k0 = trc.roll_minmax.launches, trc.roll_kv.launches
    assert torch.equal(trc.roll_minmax(x, 7), trc.roll_minmax_plain(x, 7))
    kv = trc.roll_kv(x, x + 1, 7)
    for a, b in zip(kv, trc.roll_kv_plain(x, x + 1, 7)):
        assert torch.equal(a, b)
    assert (trc.roll_minmax.launches, trc.roll_kv.launches) == (n0, k0)
    meta = torch.empty((4, 96), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        trc.roll_minmax(meta, 3)
    with pytest.raises(ValueError, match="device"):
        trc.roll_kv(meta, meta, 3)


def test_probe_input_and_floor_lines():
    """The port's probe makes the JAX probe's input, counts its floors the
    same way, and refuses to run without a card."""
    x = tprobe.probe_input(8, 416, device="cpu").numpy()
    ref = np.asarray(jnp.arange(8 * 416, dtype=jnp.int32).reshape(8, 416)
                     % (1 << 20))
    np.testing.assert_array_equal(x, ref)
    eps = 2.0e12
    lines = tprobe.floor_lines(eps, eps, 4096, 1664, 0.0325)
    floor_ms = 4096 * 1664 * tprobe.FLOOR_STAGES / eps * 1e3
    assert f"{floor_ms:.4f} ms" in lines[0]
    assert f"{2 * floor_ms:.4f} ms" in lines[1]
    assert "0.0325 ms measured" in lines[2]
    if not torch.cuda.is_available():
        assert tprobe.main(["416", "3"]) == 2
