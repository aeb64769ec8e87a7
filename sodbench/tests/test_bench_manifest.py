"""BENCHMARK.json against the contract the benchmark is written to: names,
units and keys; the files each entry names; every per-layer metric read in
cells that report the end-to-end metric it moves."""
import importlib
import json
import os
import re

import pytest

from sodbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
E2E = {m["name"]: m for m in MAN["end_to_end"]}
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["sodbench"]
    assert len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("group,kind", [("configs", "config"), ("workloads", "workload"),
                                        ("end_to_end", "end_to_end"), ("per_layer", "per_layer")])
def test_names_and_keys(group, kind):
    entries = MAN[group]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        for key in ("why", "layer", "source"):
            if key in e and isinstance(e[key], str):
                assert _line(e[key]), (e["name"], key)


def test_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert harness.metric_reader(m["name"]).read
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_layer_metric_cells_report_what_it_moves(metric):
    m = harness.by_name(MAN["per_layer"], metric, "metric")
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for cell in cells:
        assert harness.reports(E2E[m["moves"]], cell, MAN), (metric, cell)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell(cell):
    w = harness.by_name(MAN["workloads"], cell, "workload")
    assert w["chips"] in (1, 4) and _line(w["why"])
    cfg = harness.config_file(MAN, w["config"])
    traffic = harness.traffic_file(w["traffic"])
    assert importlib.import_module(f"sodbench.drivers.{traffic['driver']}").Driver
    e2e = [m["name"] for m in harness.cell_metrics(MAN, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(MAN, cell, True)
    limits = harness.limits_file(cell)["checks"]
    assert limits and all(c["limit"] is not None for c in limits.values())
    assert cfg["config"]["arch"] in ("vit_small", "resnet50")
    pairs = [(x["config"], x["traffic"]) for x in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(x["chips"] == 4 for x in MAN["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_config_file(name):
    entry = harness.by_name(MAN["configs"], name, "configuration")
    assert entry["file"].startswith("sodbench/configs/")
    body = harness.config_file(MAN, name)
    assert body["name"] == name and body["source"] == entry["source"]
    assert sorted(entry["reduced"]) == sorted(body["reduced"])
    widths = re.compile(r"(_dim|_rank|size_hidden|hidden|intermediate|heads|expansion)")
    assert not [k for k in entry["reduced"] if widths.search(k)]
    assert any(w["config"] == name for w in MAN["workloads"])
    assert os.path.isfile(os.path.join(harness.ROOT, entry["file"]))
