"""The import guard, the reference's imports, and the command's refusals:
no card, or no program beside the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness


def test_guard_names(monkeypatch):
    assert harness.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax.linen",
                 "horizonator_tpu.render"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in harness.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    for name in ("horizonator_tpu_torch", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
        assert harness.forbidden_modules() == []
        monkeypatch.delitem(sys.modules, name)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.render, "
            "portbench.reference.viewshed, portbench.reference.dem; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                       capture_output=True, text=True, check=True)
    top = set(json.loads(r.stdout.replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "horizonator_tpu",
                      "horizonator_tpu_torch"}


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "srtm3-40km.pano-single", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(harness.REPO, env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.card
def test_control_on_the_card(card):
    """The pano cell's check at its own size on the card: the program
    within its limit, the bfloat16 control past it."""
    import torch
    out, _ = harness.run_cell("srtm3-40km.pano-single", 101, 2.0, False,
                              control_dtype=torch.bfloat16)
    lim = {k: v["limit"] for k, v in out["check"].items()}
    assert all(out["program_check"][k] <= lim[k] for k in lim)
    assert not out["correct"]
