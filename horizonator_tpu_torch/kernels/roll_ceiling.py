"""Roll-ceiling probes: CUDA kernels + plain versions.

``roll_minmax`` and ``roll_kv`` launch ``csrc/roll_ceiling.cu`` for CUDA
tensors and take ``roll_minmax_plain``/``roll_kv_plain`` only for CPU
tensors. They are the counterparts of the two ``pallas_call``s of the JAX
package's ``benchmarks/profile_roll_ceiling.py`` (``make_minmax`` and
``make_kv``): ``stages`` rounds of a circular roll by +-d, d = 1 << (s %
10), and a lane-masked compare-exchange on every row of a (W, m) int32
array, the kv flavor with a value array that follows the key's exchanges.
Integer work: kernel and plain version agree bit for bit.

Two kernels serve each flavor, chosen by the row length alone:

- the register kernels (a warp per row, lane r*32 + t in register r of
  thread t) for m a multiple of 32 whose m/32 the source instantiates
  (``register_path``), launched by ``roll_minmax``/``roll_kv``;
- the shared-memory kernels (a block per row) for every other m, launched
  by ``roll_minmax_smem``/``roll_kv_smem``, which ``roll_minmax``/``roll_kv``
  call for such rows and which take any m up to their limit.

Each wrapper counts its own launches in ``<wrapper>.launches``.
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


def register_path(m: int) -> bool:
    """Whether rows of m lanes take the register kernels: m a multiple of
    32 whose m / 32 the source instantiates (``hz_roll_regs``). Needs the
    built library, so only a CUDA caller asks."""
    return m % 32 == 0 and bool(build.library().hz_roll_regs(m))


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


def _check_kv(fn: str, k: torch.Tensor, v: torch.Tensor, stages: int):
    _check(fn, k, stages, MAX_M_KV)
    if (v.device != k.device or v.dtype != torch.int32
            or v.shape != k.shape or not v.is_contiguous()):
        raise ValueError(f"{fn}: v must be a contiguous int32 "
                         f"{tuple(k.shape)} tensor on {k.device}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _launch(fn: str, entry: str, ins, stages: int):
    """Launch C entry ``entry`` on inputs ``ins``; returns the new outputs,
    one per input."""
    w, m = ins[0].shape
    outs = [torch.empty_like(a) for a in ins]
    rc = getattr(build.library(), entry)(
        *(a.data_ptr() for a in (*ins, *outs)), w, m, stages,
        torch.cuda.current_stream(ins[0].device).cuda_stream)
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")
    return outs


def roll_minmax(x: torch.Tensor, stages: int) -> torch.Tensor:
    """``stages`` minmax compare-exchange rounds on every row of x (W, m)
    int32; returns a new (W, m) int32 tensor. Rows that the register
    kernel does not take go to ``roll_minmax_smem``."""
    if x.device.type == "cpu":
        return roll_minmax_plain(x, stages)
    _check("roll_minmax", x, stages, MAX_M)
    if not register_path(x.shape[1]):
        return roll_minmax_smem(x, stages)
    out, = _launch("roll_minmax", "hz_roll_minmax", (x,), stages)
    roll_minmax.launches += 1
    return out


def roll_minmax_smem(x: torch.Tensor, stages: int) -> torch.Tensor:
    """``roll_minmax`` through the shared-memory kernel, for any m."""
    if x.device.type == "cpu":
        return roll_minmax_plain(x, stages)
    _check("roll_minmax_smem", x, stages, MAX_M)
    out, = _launch("roll_minmax_smem", "hz_roll_minmax_smem", (x,), stages)
    roll_minmax_smem.launches += 1
    return out


def roll_kv(k: torch.Tensor, v: torch.Tensor, stages: int):
    """``stages`` key-value compare-exchange rounds on every row of keys k
    and values v, both (W, m) int32; returns (keys, values). Rows that the
    register kernel does not take go to ``roll_kv_smem``."""
    if k.device.type == "cpu":
        return roll_kv_plain(k, v, stages)
    _check_kv("roll_kv", k, v, stages)
    if not register_path(k.shape[1]):
        return roll_kv_smem(k, v, stages)
    ok, ov = _launch("roll_kv", "hz_roll_kv", (k, v), stages)
    roll_kv.launches += 1
    return ok, ov


def roll_kv_smem(k: torch.Tensor, v: torch.Tensor, stages: int):
    """``roll_kv`` through the shared-memory kernel, for any m."""
    if k.device.type == "cpu":
        return roll_kv_plain(k, v, stages)
    _check_kv("roll_kv_smem", k, v, stages)
    ok, ov = _launch("roll_kv_smem", "hz_roll_kv_smem", (k, v), stages)
    roll_kv_smem.launches += 1
    return ok, ov


roll_minmax.launches = roll_minmax_smem.launches = 0
roll_kv.launches = roll_kv_smem.launches = 0
