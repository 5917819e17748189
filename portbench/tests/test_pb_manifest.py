"""BENCHMARK.json against the contract's shape, and every name resolving
to its files; a cell added as files alone is picked up."""

import json
import re
import shutil

import pytest

from portbench import harness, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert (harness.REPO / MAN["command"][1]).is_file()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["file"].startswith("portbench/")
        assert 1 <= len(c["source"]) <= 200
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    names = ([x["name"] for x in MAN["configs"]] + CELLS
             + list(e2e) + [m["name"] for m in MAN["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    f = harness.resolve(cell, MAN)
    assert f["driver"].is_file() and f["limits"]
    for mod in ("setup", "request", "viewpoints", "reference", "compare",
                "work", "tiny", "planted_faults"):
        assert callable(getattr(harness.load_module(f["driver"]), mod))
    k = traffic.kind(f["mix"], f["kinds"])
    assert callable(k.make) and callable(k.valid)
    names = [m["name"] for m, _ in f["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2 and f["per_layer"]
    for _, path in f["end_to_end"] + f["per_layer"]:
        assert callable(harness.load_module(path).read)


@pytest.mark.parametrize("new_code", [False, True])
def test_new_cell_from_files_alone(new_code, tmp_path, tiny, monkeypatch):
    """A copy of the benchmark gains a traffic mix, limits and a workload
    entry, and with ``new_code`` a driver and a viewpoint kind of its own
    too: the harness runs the new cell, and the driver's own tiny sizes and
    planted faults serve the tests, with no file that was there edited."""
    root = tmp_path / "repo"
    pb = root / "portbench"
    shutil.copytree(harness.HERE, pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((pb / "traffic/sweep1024.json").read_text())
    mix["viewpoints"]["side"] = 16
    if new_code:
        shutil.copy(pb / "drivers/viewshed_sweep.py", pb / "drivers/new.py")
        shutil.copy(pb / "kinds/lattice.py", pb / "kinds/new.py")
        mix["entry"], mix["viewpoints"]["kind"] = "new", "new"
    (pb / "traffic/new.json").write_text(json.dumps(mix))
    (pb / "limits/gis-20km.new.json").write_text(
        (pb / "limits/gis-20km.sweep1024.json").read_text())
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "gis-20km.new", "config": "gis-20km",
                             "traffic": "new", "chips": 4,
                             "why": "a new cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "gis-20km.sweep1024" in m.get("workloads", []):
            m["workloads"].append("gis-20km.new")
    f = tiny("", harness.resolve("gis-20km.new", man, repo=root))
    assert f["driver"].parent == pb / "drivers"
    assert f["mix"]["viewpoints"]["side"] == 4
    out, _ = harness.run_cell("gis-20km.new", 5, 0.2, False, device="cpu",
                              files=f)
    assert out["correct"] and "viewpoints_per_s" in out["metrics"]
    plant = harness.load_module(f["driver"]).planted_faults()["half_batch"]
    out, _ = harness.run_cell(
        "gis-20km.new", 5, 0.2, False, device="cpu", files=f,
        setup_hook=lambda ctx, state: plant(monkeypatch))
    assert not out["correct"]
