"""The one traffic generator: requests drawn from a seed by a mix's file.

A mix (``traffic/<name>.json``) names the entry it drives (``entry``, a
file of ``drivers/``) and how each request's viewpoints are drawn
(``viewpoints``), plus the entry's own parameters, which the driver reads.
``viewpoints["kind"]`` names a file of ``kinds/``: its ``make(spec,
config, rng)`` gives the function that draws the next request, and its
``valid(spec, config, request)`` says whether a request keeps to the spec.
Every request of a mix has the same sizes; the seed changes only where the
viewpoints fall. Request r of seed s is the same in every run.
"""

from __future__ import annotations

from pathlib import Path

from .loader import load_module
from .terrain import rng

KINDS = Path(__file__).resolve().parent / "kinds"


def kind(mix: dict, kinds: Path = KINDS):
    """The module of the mix's viewpoint kind, from the folder ``kinds``."""
    return load_module(Path(kinds) / f"{mix['viewpoints']['kind']}.py")


class Requests:
    """Requests of a mix for one seed: ``next()`` gives the next one as a
    dict of numpy arrays and numbers."""

    def __init__(self, mix: dict, config: dict, seed: int, stream: int = 1,
                 kinds: Path = KINDS):
        self.next = kind(mix, kinds).make(mix["viewpoints"], config,
                                          rng(seed, stream))
