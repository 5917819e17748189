"""Benchmark files loaded by path: drivers, viewpoint kinds and metric
readers are found by name, and their names may hold dots."""

from __future__ import annotations

import importlib.util
from pathlib import Path


def load_module(path: Path):
    """The file at ``path`` as a module."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
