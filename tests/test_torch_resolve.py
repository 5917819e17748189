"""Port parity: the resolve (plain version of the CUDA kernel) vs JAX.

Identical float32 rows y_k, made with numpy from a seed, go through
horizonator_tpu's resolve_window (the fused Pallas kernel in interpret
mode, as render_panorama calls it) or, where that kernel does not fit,
raymarch._resolve_rows, and through the port. idx, ok and alpha must be
bitwise equal: the port's search computes the same integer keys, brackets
and quantized alpha in the same float32 operations.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horizonator_tpu.render import raymarch as jraymarch
from horizonator_tpu.render import resolve_window as jresolve
from horizonator_tpu_torch.kernels.resolve import (SMEM, max_k, resolve,
                                                   resolve_plain)
from horizonator_tpu_torch.render import resolve_window as tresolve

_jax_rows = jax.jit(jraymarch._resolve_rows, static_argnames=("height",))


@functools.partial(jax.jit, static_argnames=("height", "monotone"))
def _jax_window(y, height, monotone):
    return jresolve.resolve_window(y, height, monotone=monotone)


def _rows(w, k, h, seed, spread=0.4):
    """Rows of a plausible march: horizons around the image middle."""
    rng = np.random.default_rng(seed)
    return (h * (0.5 + spread * rng.standard_normal((w, k)))).astype(
        np.float32)


def _check(y, h, ref):
    got = tresolve.resolve_window(torch.from_numpy(y), h)
    for name, r, g in zip(("idx", "alpha", "ok"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("w,k,h,seed", [(24, 90, 128, 0), (16, 300, 100, 1),
                                        (8, 580, 37, 2), (12, 200, 130, 3)])
def test_resolve_matches_fused_kernel(w, k, h, seed):
    y = _rows(w, k, h, seed)
    assert tresolve.resolve_fits(k, h)
    _check(y, h, _jax_window(jnp.asarray(y), h, False))


def test_resolve_monotone_input():
    y = np.minimum.accumulate(_rows(16, 150, 128, 5), axis=1)
    _check(y, 128, _jax_window(jnp.asarray(y), 128, True))


def test_exact_ties_count_as_crossings():
    # rows landing exactly on pixel rows (keys 256h) and on 1/256 steps
    rng = np.random.default_rng(9)
    y = rng.integers(-4, 70, (10, 64)).astype(np.float32)
    y[:, ::3] += rng.integers(0, 256, (10, 22)).astype(np.float32) / 256.0
    _check(y, 64, _jax_window(jnp.asarray(y), 64, False))
    idx = tresolve.resolve_window(torch.from_numpy(y), 64)[0].numpy()
    keys = np.minimum.accumulate(np.round(y * 256.0), axis=1)
    want = (keys[:, :, None] > 256.0 * np.arange(64)).sum(axis=1)
    np.testing.assert_array_equal(idx, want)


def test_huge_rows_clip():
    k, h = 64, 128
    base = np.linspace(140.0, -10.0, k, dtype=np.float32)
    y = np.stack([
        base,
        np.concatenate([[5.0e6] * 8, base[8:]]),
        np.full(k, 5.0e6, np.float32),
        np.concatenate([[2.0 ** 30 / 256.0] * 4, base[4:]]),
        np.linspace(-300.0, -400.0, k, dtype=np.float32),
        np.full(k, 3.0e38, np.float32),
    ]).astype(np.float32)
    _check(y, h, _jax_window(jnp.asarray(y), h, False))


@pytest.mark.parametrize("w,k,h", [(6, 4000, 128), (4, 64, 4096)])
def test_fallback_regime_matches_resolve_rows(w, k, h):
    """(K, H) where the fused kernel does not fit: the JAX package resolves
    run_max rows with _resolve_rows; the port's raw-row search, with that
    path's alpha quantum, must give the same numbers."""
    assert not tresolve.resolve_fits(k, h)
    y = _rows(w, k, h, 11)
    ref = _jax_rows(jnp.asarray(np.minimum.accumulate(y, axis=1)), h)
    _check(y, h, ref)


def test_wrapper_takes_plain_version_on_cpu():
    y = torch.from_numpy(_rows(4, 50, 32, 2))
    for a, b in zip(resolve(y, 32, 1023.0, True),
                    resolve_plain(y, 32, 1023.0, True)):
        assert torch.equal(a, b)
    assert resolve.launches == 0          # no kernel on CPU tensors


# -- edge shapes and columns ---------------------------------------------------

@functools.partial(jax.jit, static_argnames=("height",))
def _jax_window_tex(y, tex, height):
    return jresolve.resolve_window(y, height, tex=tex, monotone=False)


def _edge_cases():
    """name -> (rows y (W, K) float32, H): where a resolve's index
    arithmetic can go wrong. Inputs from seeded numpy."""
    rng = np.random.default_rng(13)
    cases = {"H_100": (_rows(8, 200, 100, 21), 100),
             "H_1023": (_rows(4, 129, 1023, 22), 1023),
             "K_129": (_rows(8, 129, 64, 23), 64)}
    for k in (1, 2):
        y = _rows(12, k, 64, 24 + k)
        y[0], y[1], y[2] = 70.0, -3.0, 17.0     # sky, covered, a pixel row
        cases[f"K_{k}"] = (y, 64)
    y = _rows(8, 64, 64, 27)
    y[0] = 64.0 + 5.0 * rng.random(64)          # all sky: idx K everywhere
    y[1, 0] = -2.0                              # covered from sample 0
    y[2, 0] = 0.0                               # key 0 equals threshold 0
    y[3] = 63.0                                 # one crossing, the last row
    cases["sky_and_covered"] = (y.astype(np.float32), 64)
    # keys at and below the image top: exact negative multiples of 256 and
    # 1/256 steps between them
    y = (rng.integers(-8, 70, (8, 64)).astype(np.float32)
         - rng.integers(0, 2, (8, 64)) * rng.integers(0, 256, (8, 64))
         / np.float32(256.0)).astype(np.float32)
    y[:, :8] = np.sort(y[:, :8], axis=1)[:, ::-1]
    cases["negative_keys"] = (y, 64)
    cases["threshold_equals_key"] = (
        rng.integers(0, 64, (8, 64)).astype(np.float32), 64)
    # a long plateau, a cliff owning > 256 rows, a plateau again, a ramp
    y = np.empty((4, 600), np.float32)
    y[:, :200] = 1000.25
    y[:, 200:330] = 20.5
    y[:, 330:] = 20.5 - np.arange(270, dtype=np.float32) * 0.07
    y[1, 100] = 700.0                           # a dip inside the plateau
    y[2, 199] = 300.0
    y[3] += rng.random(600).astype(np.float32) * 0.01
    cases["cliff_beside_plateau"] = (y, 1024)
    return cases


_EDGE = _edge_cases()


@pytest.mark.parametrize("textured", [False, True],
                         ids=["untextured", "textured"])
@pytest.mark.parametrize("name", list(_EDGE))
def test_resolve_edge_cases_match_fused_kernel(name, textured):
    y, h = _EDGE[name]
    k = y.shape[1]
    assert tresolve.resolve_fits(k, h)
    if not textured:
        _check(y, h, _jax_window(jnp.asarray(y), h, False))
    else:
        tex = np.random.default_rng(14).integers(
            1, 1 << 24, y.shape).astype(np.int32)
        ref = _jax_window_tex(jnp.asarray(y), jnp.asarray(tex), h)
        got = tresolve.resolve_window(torch.from_numpy(y), h,
                                      tex=torch.from_numpy(tex))
        for what, r, g in zip(("idx", "alpha", "ok", "tex"), ref, got):
            np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                          err_msg=what)
    idx = tresolve.resolve_window(torch.from_numpy(y), h)[0].numpy()
    if name == "sky_and_covered":
        assert (idx[0] == k).all() and (idx[1] == 0).all()
        assert (idx[2] == 0).all()
        assert (idx[3, :63] == k).all() and idx[3, 63] == 0
        ok = tresolve.resolve_window(torch.from_numpy(y), h)[2].numpy()
        assert not ok[:3].any()
    if name == "cliff_beside_plateau":
        assert (idx[0, 21:1001] == 200).all()   # the cliff's sample owns them


def _ceil256(x):
    return -(-x // 256)


def _owned_rows(keys, k, h):
    """The pixel rows that sample k of the non-increasing ``keys`` owns:
    [ceil(key[k] / 256), ceil(key[k-1] / 256)) within [0, h), key[-1] =
    +inf; none for a sample on a plateau."""
    if k > 0 and keys[k] >= keys[k - 1]:
        return range(0)
    r0 = max(_ceil256(int(keys[k])), 0)
    r1 = h if k == 0 else min(_ceil256(int(keys[k - 1])), h)
    return range(r0, max(r0, r1))


def _property_rows(seed, w=12, k=150, h=96):
    """Columns with ties, plateaus, cliffs and keys above the image top."""
    rng = np.random.default_rng(seed)
    y = np.cumsum(-rng.exponential(1.5, (w, k)) * rng.integers(0, 2, (w, k)),
                  axis=1) + h + 8.0 + 6.0 * rng.standard_normal((w, k))
    y[::3] = np.round(y[::3])                  # keys at multiples of 256
    y[1::4] -= rng.integers(0, 2 * h, (len(y[1::4]), 1))   # tops above row 0
    return y.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_sample_owns_one_run_of_rows(seed):
    """The identity the CUDA kernel rests on: idx == k exactly on the rows
    sample k owns, and K on the rows that no sample owns."""
    h = 96
    y = _property_rows(seed)
    w, k = y.shape
    idx = resolve_plain(torch.from_numpy(y), h, 1023.0, True)[0].numpy()
    keys = np.minimum.accumulate(np.clip(np.round(
        y.astype(np.float64) * 256.0), -2.0 ** 30, 2.0 ** 30), axis=1).astype(
            np.int64)
    assert (keys < 0).any() and (keys % 256 == 0).any()
    assert (np.diff(keys, axis=1) == 0).any()
    for c in range(w):
        want = np.full(h, k)
        owned = np.zeros(h, int)
        for s in range(k):
            rows = _owned_rows(keys[c], s, h)
            want[rows.start:rows.stop] = s
            owned[rows.start:rows.stop] += 1
        assert owned.max() <= 1                 # the runs do not overlap
        np.testing.assert_array_equal(idx[c], want)


@pytest.mark.parametrize("seed", [3, 4])
def test_scatter_and_running_min_fill_the_runs(seed):
    """The kernel's form of that identity: each owner writes its index at
    the first row of its run into an array preset to K (ceil as an
    arithmetic shift), and a running min over the rows fills the runs."""
    h = 96
    y = _property_rows(seed)
    w, k = y.shape
    idx = resolve_plain(torch.from_numpy(y), h, 1023.0, True)[0].numpy()
    keys = np.minimum.accumulate(np.clip(np.round(
        y.astype(np.float64) * 256.0), -2.0 ** 30, 2.0 ** 30), axis=1).astype(
            np.int32)
    for c in range(w):
        mark = np.full(h, k, np.int32)
        for s in range(k):
            if s == 0 or keys[c, s] < keys[c, s - 1]:
                r0 = max((int(keys[c, s]) + 255) >> 8, 0)
                r1 = h if s == 0 else min((int(keys[c, s - 1]) + 255) >> 8, h)
                if r0 < r1:
                    assert mark[r0] == k        # no two owners share a row
                    mark[r0] = s
        np.testing.assert_array_equal(idx[c], np.minimum.accumulate(mark))


@pytest.mark.parametrize("k,h", [(580, 1024), (4000, 128), (64, 4096),
                                 (600, 1023)])
def test_kernel_limit_admits_the_render_shapes(k, h):
    """The CUDA kernel keeps the (H,) row array, the keys and, textured,
    the colors in one block's shared memory; the wrapper's limit follows
    that layout and admits the bench and the fallback-regime shapes."""
    assert k <= max_k(h, True) < max_k(h, False)


def test_kernel_limit_is_the_shared_memory_layout():
    for h in (1, 100, 1024, 4096):
        rows = -(-h // 4) * 4
        for textured in (False, True):
            k = max_k(h, textured)
            words = rows + 12 + (k + 2) + ((k + 1) if textured else 0)
            assert 4 * words <= SMEM < 4 * (words + (2 if textured else 1))
    assert max_k(SMEM, False) <= 0      # the row array alone does not fit
