"""Roll-ceiling probes: CUDA kernels + plain versions.

``roll_minmax`` and ``roll_kv`` launch ``csrc/roll_ceiling.cu`` for CUDA
tensors and take ``roll_minmax_plain``/``roll_kv_plain`` only for CPU
tensors. They are the counterparts of the two ``pallas_call``s of the JAX
package's ``benchmarks/profile_roll_ceiling.py`` (``make_minmax`` and
``make_kv``): ``stages`` rounds of a circular roll by +-d, d = 1 << (s %
10), and a lane-masked compare-exchange on every row of a (W, m) int32
array, the kv flavor with a value array that follows the key's exchanges.
Integer work: kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from . import build

SMEM = 227 * 1024                  # a block's shared memory on the H100
MAX_M = SMEM // 8                  # one row, double-buffered
MAX_M_KV = SMEM // 16              # keys and values, double-buffered


def _shifts(s: int, m: int):
    """(d, the roll bringing x[i + d] to lane i, the one bringing x[i - d])
    for stage s, as the JAX probe rolls."""
    d = 1 << (s % 10)
    return d, (m - d % m) % m, d % m


def roll_minmax_plain(x: torch.Tensor, stages: int) -> torch.Tensor:
    """The minmax probe's body (profile_roll_ceiling.py:48-57) in torch."""
    m = x.shape[1]
    lane = torch.arange(m, dtype=torch.int32, device=x.device)
    for s in range(stages):
        d, sh_f, sh_b = _shifts(s, m)
        fwd = torch.roll(x, sh_f, dims=1)
        bwd = torch.roll(x, sh_b, dims=1)
        low = (lane & d) == 0
        x = torch.where(low, torch.minimum(x, fwd), torch.maximum(x, bwd))
    return x


def roll_kv_plain(k: torch.Tensor, v: torch.Tensor, stages: int):
    """The kv probe's body (profile_roll_ceiling.py:72-92) in torch."""
    m = k.shape[1]
    lane = torch.arange(m, dtype=torch.int32, device=k.device)
    for s in range(stages):
        d, sh_f, sh_b = _shifts(s, m)
        low = (lane & d) == 0
        k_other = torch.where(low, torch.roll(k, sh_f, dims=1),
                              torch.roll(k, sh_b, dims=1))
        v_other = torch.where(low, torch.roll(v, sh_f, dims=1),
                              torch.roll(v, sh_b, dims=1))
        k_new = torch.where(low, torch.minimum(k, k_other),
                            torch.maximum(k, k_other))
        v = torch.where(k_new != k, v_other, v)
        k = k_new
    return k, v


def _check(fn: str, x: torch.Tensor, stages: int, max_m: int):
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{fn}: expected a contiguous 2-D int32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not 0 < x.shape[1] <= max_m:
        raise ValueError(f"{fn}: m={x.shape[1]} outside (0, {max_m}]")
    if stages < 0:
        raise ValueError(f"{fn}: stages {stages} < 0")


def roll_minmax(x: torch.Tensor, stages: int) -> torch.Tensor:
    """``stages`` minmax compare-exchange rounds on every row of x (W, m)
    int32; returns a new (W, m) int32 tensor."""
    if x.device.type == "cpu":
        return roll_minmax_plain(x, stages)
    _check("roll_minmax", x, stages, MAX_M)
    w, m = x.shape
    out = torch.empty_like(x)
    rc = build.library().hz_roll_minmax(
        x.data_ptr(), out.data_ptr(), w, m, stages,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"roll_minmax launch failed: CUDA error {rc}")
    roll_minmax.launches += 1
    return out


roll_minmax.launches = 0


def roll_kv(k: torch.Tensor, v: torch.Tensor, stages: int):
    """``stages`` key-value compare-exchange rounds on every row of keys k
    and values v, both (W, m) int32; returns (keys, values)."""
    if k.device.type == "cpu":
        return roll_kv_plain(k, v, stages)
    _check("roll_kv", k, stages, MAX_M_KV)
    if (v.device != k.device or v.dtype != torch.int32
            or v.shape != k.shape or not v.is_contiguous()):
        raise ValueError(f"roll_kv: v must be a contiguous int32 "
                         f"{tuple(k.shape)} tensor on {k.device}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")
    w, m = k.shape
    ok, ov = torch.empty_like(k), torch.empty_like(v)
    rc = build.library().hz_roll_kv(
        k.data_ptr(), v.data_ptr(), ok.data_ptr(), ov.data_ptr(), w, m,
        stages, torch.cuda.current_stream(k.device).cuda_stream)
    if rc:
        raise RuntimeError(f"roll_kv launch failed: CUDA error {rc}")
    roll_kv.launches += 1
    return ok, ov


roll_kv.launches = 0
