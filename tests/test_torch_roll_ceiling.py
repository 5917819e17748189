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
value must stay. m 32 and 96 are below most shifts (d % m differs from d
at every d >= m), m 1000 is not a multiple of 32 (the card's general,
shared-memory path), and 0 stages is the identity.

``_emulate_registers`` repeats the card's register kernels' layout in
torch (lane r*32 + t in register r of thread t; xor exchanges between
threads for d < 32; register partners (r +- (d % m)/32) mod R within a
thread for d >= 32, in pair form with one-sided wrapped lanes) and is held
against the plain versions at every m the layout can take up to 2048.
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
SHAPES = [(m, s) for m in (32, 96, 256, 416, 1000) for s in (0, 1, 10, 13, 40)]
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


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


@functools.lru_cache(maxsize=None)
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
    assert np.array_equal(ref, x) == (stages == 0)


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
    moved = (rv != v).mean()
    if stages == 0:
        assert moved == 0.0
    else:
        assert 0.0 < moved < 1.0        # values moved, and ties kept some


def _thread_partner(r, d, nregs):
    """(partner register, whether the two point at each other with opposite
    roles) of register r at d >= 32 in the register layout."""
    big, dm = d // 32, (d // 32) % nregs

    def partner(q):
        return (q + dm) % nregs if q & big == 0 else (q - dm) % nregs

    p = partner(r)
    return p, p != r and partner(p) == r and (p & big == 0) != (r & big == 0)


def _emulate_registers(k, v, stages):
    """The register kernels' layout and stage bodies in torch; v None is
    the minmax flavor. k, v: (W, m) int32, m a multiple of 32."""
    w, m = k.shape
    nregs = m // 32
    k = k.reshape(w, nregs, 32)
    v = None if v is None else v.reshape(w, nregs, 32)
    t = torch.arange(32)
    for s in range(stages):
        d = 1 << (s % 10)
        if d < 32:                      # xor shuffles between threads
            low = (t & d) == 0
            o = k[:, :, t ^ d]
            y = torch.where(low, torch.minimum(k, o), torch.maximum(k, o))
            if v is not None:
                v = torch.where(y != k, v[:, :, t ^ d], v)
            k = y
            continue
        nk = k.clone()
        nv = None if v is None else v.clone()
        for r in range(nregs):          # partners within a thread
            p, pair = _thread_partner(r, d, nregs)
            low = r & (d // 32) == 0
            if v is None:
                nk[:, r] = (torch.minimum if low else torch.maximum)(
                    k[:, r], k[:, p])
            elif pair and low:          # the pair (r, p), written once
                swap = k[:, r] > k[:, p]
                nk[:, r] = torch.minimum(k[:, r], k[:, p])
                nk[:, p] = torch.maximum(k[:, r], k[:, p])
                nv[:, r] = torch.where(swap, v[:, p], v[:, r])
                nv[:, p] = torch.where(swap, v[:, r], v[:, p])
            elif not pair and p != r:   # one-sided: p's partner is not r
                take = k[:, p] < k[:, r] if low else k[:, p] > k[:, r]
                nk[:, r] = torch.where(take, k[:, p], k[:, r])
                nv[:, r] = torch.where(take, v[:, p], v[:, r])
        k, v = nk, nv
    return k.reshape(w, m), None if v is None else v.reshape(w, m)


@pytest.mark.parametrize("m", range(32, 2049, 32))
def test_register_layout_emulation_bitwise(m):
    """Every m the register layout can take, 20 stages (d 1 to 512 twice),
    wide and tie-heavy keys with INT32_MIN and INT32_MAX in every array."""
    rng = np.random.default_rng(m)

    def arr(lo, hi):
        a = rng.integers(lo, hi, (3, m), dtype=np.int64)
        u = rng.random((3, m))
        a[u < 0.05], a[(u >= 0.05) & (u < 0.1)] = INT32_MIN, INT32_MAX
        return torch.from_numpy(a.astype(np.int32))

    x, v = arr(INT32_MIN, INT32_MAX + 1), arr(INT32_MIN, INT32_MAX + 1)
    got, _ = _emulate_registers(x, None, 20)
    assert torch.equal(got, trc.roll_minmax_plain(x, 20))
    for k in (x, arr(0, 16)):
        gk, gv = _emulate_registers(k, v, 20)
        rk, rv = trc.roll_kv_plain(k, v, 20)
        assert torch.equal(gk, rk) and torch.equal(gv, rv)


def test_register_layout_one_sided_lanes():
    """The wrapped lanes that the source note counts: at m 1664 (R 52), 128
    one-sided lanes at d 128 and 256 and 384 at d 512, none at d 32 and 64;
    at m <= 512 every lane of a stage with d >= m is one-sided or meets
    itself."""
    def one_sided(m, d):
        nregs = m // 32
        return 32 * sum(not pair and p != r for r in range(nregs)
                        for p, pair in [_thread_partner(r, d, nregs)])

    assert [one_sided(1664, 32 << e) for e in range(5)] == [0, 0, 128, 128,
                                                            384]
    for m in (32, 96, 256, 416, 512):
        for d in (32 << e for e in range(5)):
            if d >= m:
                nregs = m // 32
                assert all(not _thread_partner(r, d, nregs)[1]
                           for r in range(nregs))


def test_wrappers_route_and_check():
    """CPU tensors take the plain versions and launch nothing; any other
    device goes to the kernel's checks (no silent fallback)."""
    x = tprobe.probe_input(4, 96, device="cpu")
    counters = (trc.roll_minmax, trc.roll_kv, trc.roll_minmax_smem,
                trc.roll_kv_smem)
    n0 = [fn.launches for fn in counters]
    for mm in (trc.roll_minmax, trc.roll_minmax_smem):
        assert torch.equal(mm(x, 7), trc.roll_minmax_plain(x, 7))
    for kv in (trc.roll_kv, trc.roll_kv_smem):
        for a, b in zip(kv(x, x + 1, 7), trc.roll_kv_plain(x, x + 1, 7)):
            assert torch.equal(a, b)
    assert [fn.launches for fn in counters] == n0
    meta = torch.empty((4, 96), dtype=torch.int32, device="meta")
    for mm in (trc.roll_minmax, trc.roll_minmax_smem):
        with pytest.raises(ValueError, match="device"):
            mm(meta, 3)
    for kv in (trc.roll_kv, trc.roll_kv_smem):
        with pytest.raises(ValueError, match="device"):
            kv(meta, meta, 3)


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
