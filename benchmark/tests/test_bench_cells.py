"""The harness finds each cell's files by name, and BENCHMARK.json keeps
to the contract's shape."""

import json
import re

import pytest

from benchmark import harness
from benchmark.traffic import Mix

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["mapper"]["camera"]["width"] == 1241
    assert isinstance(c.mix, Mix)
    assert set(c.limits) == {"step_rows_off", "warp_gap"}
    names = [m["name"] for m in c.end_to_end + c.per_layer]
    assert "setup_s" in names and len(c.end_to_end) >= 2 and c.per_layer
    for name in names:
        assert callable(harness.reader(name))


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        doc = json.loads((harness.ROOT / c["file"]).read_text())
        assert doc["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    moved = {}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        moved[m["name"]] = set(m.get("workloads", [
            w["name"] for w in SPEC["workloads"]]))
    for m in SPEC["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= moved[m["moves"]]
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(SPEC)) < 64 * 1024
