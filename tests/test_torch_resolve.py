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
from horizonator_tpu_torch.kernels.resolve import resolve, resolve_plain
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
