"""BENCHMARK.json and the files it names: each loads, by its name alone,
and keeps to the benchmark's contract (names, units, metrics reported in
every cell that their end-to-end metric is reported in, limits for every
cell). CPU only."""

import json
import math

import pytest

from portbench import core

BENCH = core.benchmark()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]
MAX_CELLS = 24


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * MAX_CELLS
    total = (runs * (BENCH["run_seconds"] + 60) + MAX_CELLS * 2 * 90 + 1200)
    assert total <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    conf = core.load_json(core.ROOT / entry["file"])
    assert conf["name"] == entry["name"]
    assert conf["reduced"] == entry["reduced"]
    assert 1 <= len(entry["source"]) <= 200 and "\n" not in entry["source"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    w = core.cell(BENCH, name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    mix = core.traffic(w["traffic"])
    drv = core.driver(mix["driver"])
    assert hasattr(drv, "Driver")
    assert mix["limits"] and all(isinstance(v, (int, float)) and v >= 0
                                 for v in mix["limits"].values())
    core.config_file(BENCH, w["config"])


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS +
             [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] +
             [w["traffic"] for w in BENCH["workloads"]])
    assert all(core.NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[kind]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(ms) == len(set(ms))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert core.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_end_to_end_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert 1 <= len(m["layer"]) <= 200
    reader = core.metric_reader(m["name"])
    assert callable(reader.read)
    moves = E2E[m["moves"]]
    for cell in m.get("workloads", CELLS):
        assert cell in moves.get("workloads", CELLS)
    if m["unit"] == "%" and "roofline" in m["name"]:
        assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_enough(name):
    e2e = [m["name"] for m in core.metrics_of(BENCH, name, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert core.metrics_of(BENCH, name, "per_layer")


def test_readers_return_nothing_without_data():
    ctx = {"spans": {}, "trace": {}, "values": {}, "window_s": 1.0}
    for m in BENCH["per_layer"]:
        assert core.metric_reader(m["name"]).read(ctx) is None, m["name"]


def test_idle_reader_reads_a_share():
    ctx = {"spans": {}, "values": {}, "window_s": 1.0,
           "trace": {"busy_s": 0.75, "window_s": 1.0}}
    assert math.isclose(core.metric_reader("idle.sim").read(ctx), 25.0)
