"""Faults planted under the timed path, for the tests that see a run's
check catch them. Each takes pytest's ``monkeypatch`` and plants itself in
the program; a driver's ``planted_faults()`` names the ones its cells can
have."""

from __future__ import annotations


def altered_march(monkeypatch):
    """The window march's far field raised by 0.1 in its first quarter of
    columns at every valid sample, as a kernel fault would: an answer
    altered where it is produced."""
    import torch

    import horizonator_tpu_torch.render.window as window
    real = window.march

    def march(dem, pcol, fscal, k, *a, **kw):
        out = real(dem, pcol, fscal, k, *a, **kw)
        w = out.shape[-2]
        bad = out[..., : max(1, w // 4), :]
        bad.copy_(torch.where(bad > -1e38, bad + 0.1, bad))
        return out
    monkeypatch.setattr(window, "march", march)
