"""Resolve: first-crossing sample per pixel row, CUDA kernel + plain version.

``resolve`` launches ``csrc/resolve.cu`` for CUDA tensors and takes
``resolve_plain`` only for CPU tensors. Input: raw horizon rows y (W, K)
float32 (each march sample's elevation as a continuous pixel row, top =
0). Output per (column, pixel row h), each (W, H):

    idx   int32: the first sample whose running horizon reaches row h (an
          exactly equal 1/256-px key counts), K if none;
    alpha float32: the refine fraction between samples idx-1 and idx,
          quantized to multiples of 1/amax;
    ok    bool: idx in (0, K), i.e. both refine brackets exist.

This is the contract of horizonator_tpu/render/resolve_window.py's fused
kernel, bit for bit; see csrc/resolve.cu for the algorithm and for
``int_first``. ``resolve_textured`` adds

    tex   int32: the packed color of sample idx (the first-crossing
          sample, which is also the argmin that the JAX kernel's running
          min carries), 0 where idx == K (sky).
"""

from __future__ import annotations

import torch

from . import build
from ..geometry import recip

BIG = 1 << 30
SMEM = 227 * 1024                  # a block's shared memory on the H100
ROWS = 4                           # csrc/resolve.cu: pixel rows per thread
EXTRA_WORDS = 3 * 4 + 2            # its warps' exchange words, 2 sentinels


def max_k(height: int, textured: bool) -> int:
    """The most samples K whose keys (and colors, when ``textured``) fit
    one block's shared memory beside the kernel's (height,) row array;
    <= 0 where the row array alone does not fit."""
    rows = -(-height // ROWS) * ROWS
    words = SMEM // 4 - rows - EXTRA_WORDS
    return (words - 1) // 2 if textured else words    # colors: 1 sentinel


def quantize_rows(y: torch.Tensor) -> torch.Tensor:
    """Rows -> int32 keys at 1/256 px, clipped so that <<1 cannot overflow
    (resolve_window.py:128-130)."""
    yq = torch.clamp(torch.round(y * 256.0), -2.0 ** 30, 2.0 ** 30)
    return torch.clamp(yq.to(torch.int32), -(BIG - 1), BIG - 1)


def resolve_plain(y: torch.Tensor, height: int, amax: float,
                  int_first: bool, tex: torch.Tensor | None = None):
    """(idx, alpha, ok[, tex]): the kernel's function as cummin +
    searchsorted (the kernel finds idx by each sample's run of rows)."""
    w, k = y.shape
    keys = torch.cummin(quantize_rows(y), dim=1).values   # non-increasing
    thr = (torch.arange(height, dtype=torch.int32, device=y.device)
           << 8)[None, :].expand(w, height)
    # count of keys > thr == count of -keys < -thr on the ascending -keys
    idx = torch.searchsorted((-keys).contiguous(), (-thr).contiguous(),
                             out_int32=True)
    has_cur = idx < k
    has_prev = idx > 0
    cur = idx.clamp(max=k - 1).long()
    y_cur = torch.where(has_cur, torch.gather(keys, 1, cur), -BIG)
    y_prev = torch.where(
        has_prev, torch.gather(keys, 1, (idx - 1).clamp(min=0).long()), BIG)
    denom = (y_prev - y_cur).to(torch.float32)
    ok = (y_cur > -BIG) & (y_prev < BIG) & (denom > 0)
    if int_first:
        num = (y_prev - thr).to(torch.float32)
    else:
        num = y_prev.to(torch.float32) - thr.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=y.device)
    alpha = torch.clamp(num / torch.where(denom > 0, denom, one), 0.0, 1.0)
    # the decode's `/ amax` is a product with the float32 reciprocal in XLA
    alpha = torch.round(alpha * amax) * recip(amax)
    if tex is None:
        return idx, alpha, ok
    return idx, alpha, ok, torch.where(has_cur, torch.gather(tex, 1, cur), 0)


def _check_resolve(fn: str, y: torch.Tensor, height: int, textured: bool):
    if y.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {y.device}")
    if y.dtype != torch.float32 or y.dim() != 2 or not y.is_contiguous():
        raise ValueError(f"{fn}: y must be a contiguous 2-D float32 "
                         f"tensor, got {y.dtype} {tuple(y.shape)}")
    if not 0 < height < (1 << 22):
        raise ValueError(f"{fn}: height {height} out of range")
    limit = max_k(height, textured)
    if not 0 < y.shape[1] <= limit:
        raise ValueError(f"{fn}: K={y.shape[1]} outside (0, {limit}] at "
                         f"height {height}: the keys and the row array "
                         f"must fit {SMEM} bytes of shared memory")


def _outputs(w: int, height: int, device):
    return (torch.empty((w, height), dtype=torch.int32, device=device),
            torch.empty((w, height), dtype=torch.float32, device=device),
            torch.empty((w, height), dtype=torch.bool, device=device))


def resolve(y: torch.Tensor, height: int, amax: float, int_first: bool):
    """(idx int32, alpha float32, ok bool), each (W, height), from raw rows
    y (W, K) float32; ``amax``: the alpha quantum's denominator."""
    if y.device.type == "cpu":
        return resolve_plain(y, height, amax, int_first)
    _check_resolve("resolve", y, height, False)
    w, k = y.shape
    idx, alpha, ok = _outputs(w, height, y.device)
    rc = build.library().hz_resolve(
        y.data_ptr(), w, k, height, amax, recip(amax), int(bool(int_first)),
        idx.data_ptr(), alpha.data_ptr(), ok.data_ptr(),
        torch.cuda.current_stream(y.device).cuda_stream)
    if rc:
        raise RuntimeError(f"resolve launch failed: CUDA error {rc}")
    resolve.launches += 1
    return idx, alpha, ok


resolve.launches = 0


def resolve_textured(y: torch.Tensor, tex: torch.Tensor, height: int,
                     amax: float, int_first: bool):
    """``resolve`` plus each pixel row's first-crossing color (W, height)
    int32, from the samples' packed colors ``tex`` (W, K) int32."""
    if y.device.type == "cpu":
        return resolve_plain(y, height, amax, int_first, tex=tex)
    _check_resolve("resolve_textured", y, height, True)
    w, k = y.shape
    if (tex.device != y.device or tex.dtype != torch.int32
            or tuple(tex.shape) != (w, k) or not tex.is_contiguous()):
        raise ValueError(f"resolve_textured: tex must be a contiguous int32 "
                         f"{(w, k)} tensor on {y.device}, got {tex.dtype} "
                         f"{tuple(tex.shape)} on {tex.device}")
    idx, alpha, ok = _outputs(w, height, y.device)
    tex_out = torch.empty((w, height), dtype=torch.int32, device=y.device)
    rc = build.library().hz_resolve_tex(
        y.data_ptr(), tex.data_ptr(), w, k, height, amax, recip(amax),
        int(bool(int_first)), idx.data_ptr(), alpha.data_ptr(),
        ok.data_ptr(), tex_out.data_ptr(),
        torch.cuda.current_stream(y.device).cuda_stream)
    if rc:
        raise RuntimeError(f"textured resolve launch failed: CUDA error {rc}")
    resolve_textured.launches += 1
    return idx, alpha, ok, tex_out


resolve_textured.launches = 0
