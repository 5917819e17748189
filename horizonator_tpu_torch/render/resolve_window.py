"""The resolve entry: raw horizon rows -> (idx, alpha, ok) per pixel row.

Counterpart of horizonator_tpu.render.resolve_window. The TPU kernel's
packing plan (``_plan``) survives here only for what it fixes in the
contract: the alpha quantum 1/(2^a_bits - 1), and whether the JAX package
takes its fused kernel at all (``resolve_fits``). Where it does not, the
JAX package falls back to raymarch._resolve_rows, whose alpha has another
quantum and rounds its numerator differently; ``alpha_quantum`` names both
so that ``resolve_to_image`` gives the JAX numbers in either regime. The
search itself runs in kernels/resolve.py.

Textured resolves route each pixel's first-crossing color in both regimes.
The fused kernel's contract (the running min's argmin color) is exactly
the color of sample idx. The JAX fallback instead forward-fills colors
from the argmax of the raw tangents through its merge, whose order among
equal quantized keys is the network's; where a later sample raised the
horizon by less than 1/512 px it can deliver that sample's color. The port
keeps the first-crossing color there too (tests/test_torch_textured.py
counts those pixels).

A batch's rows (B, W, K) resolve as B*W columns of one launch: the kernel
takes one block a column, and the alpha quantum depends on (K, H) alone,
so one ``amax`` serves the whole batch.
"""

from __future__ import annotations

import torch

from ..kernels.resolve import resolve as _resolve, resolve_plain, \
    resolve_textured

_A_CAP = 10        # alpha bit budget cap (resolve_window.py:73)
_N2_MAX = 4096     # the TPU kernel's VMEM cap on the merged lane count


def _plan(k: int, height: int):
    """(kp, hp, hb, kb, a_bits, n2, m) of the TPU kernel's packed layout."""
    kp = -(-k // 128) * 128
    hp = max(-(-height // 128) * 128, 128)
    hb = max((hp - 1).bit_length(), 1)
    kb = max(kp.bit_length(), 1)
    a_bits = min(31 - hb - kb - 1, _A_CAP)
    m = kp + hp
    n2 = 1 << (m - 1).bit_length()
    return kp, hp, hb, kb, a_bits, n2, m


def resolve_fits(k: int, height: int) -> bool:
    """Whether the JAX package resolves (K, H) with its fused kernel."""
    plan = _plan(k, height)
    return plan[4] >= 5 and plan[5] <= _N2_MAX


def alpha_quantum(k: int, height: int) -> tuple[float, bool]:
    """(amax, int_first) of the JAX package's resolve for (K, H): the fused
    kernel's when ``resolve_fits``, else raymarch._resolve_rows' (its packed
    branch's budget, or 32767 below 5 bits, raymarch.py:525-530, 554)."""
    if resolve_fits(k, height):
        return float((1 << _plan(k, height)[4]) - 1), True
    rank_bits = height.bit_length()
    idx_bits = max((k + height).bit_length(), 1)
    a_bits = 32 - 1 - rank_bits - idx_bits - 1
    return float((1 << a_bits) - 1 if a_bits >= 5 else 32767), False


def resolve_window(y_k: torch.Tensor, height: int, *,
                   tex: torch.Tensor | None = None, plain: bool = False):
    """(idx, alpha, ok[, tex]), each (W, height), for rows y_k (W, K): the
    JAX package's numbers for (K, height), from its fused kernel where
    ``resolve_fits`` and from raymarch._resolve_rows elsewhere. Rows may be
    raw or already monotone (the running min of a non-increasing row is
    itself). ``tex`` (W, K) int32: the samples' packed colors; adds each
    pixel's first-crossing color. ``plain`` runs the plain PyTorch version
    on any device (for comparisons with the kernel). Leading batch axes,
    (B, W, K) -> (B, W, height), fold into the columns."""
    lead, k = y_k.shape[:-1], y_k.shape[-1]
    amax, int_first = alpha_quantum(k, height)
    y_k = y_k.reshape(-1, k).contiguous()
    if tex is not None:
        tex = tex.to(torch.int32).reshape(-1, k).contiguous()
        if plain:
            out = resolve_plain(y_k, height, amax, int_first, tex=tex)
        else:
            out = resolve_textured(y_k, tex, height, amax, int_first)
    else:
        out = (resolve_plain if plain else _resolve)(y_k, height, amax,
                                                     int_first)
    return tuple(o.view(*lead, height) for o in out)
