"""BENCHMARK.json holds to the contract's shape, and every cell, metric
and configuration it names has its file under benchmark/."""

import json
import os
import re

ROOT = __file__.rsplit("/benchmark/", 1)[0]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))


def test_every_cell_has_its_files_and_metrics():
    b = _bench()
    configs = {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           w["name"] + ".json"))
        reports = [m for m in b["end_to_end"]
                   if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in reports}
        assert any(w["name"] in m.get("workloads", cells)
                   for m in b["per_layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    # a per-layer metric is listed only in cells that report what it moves
    for m in b["per_layer"]:
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
