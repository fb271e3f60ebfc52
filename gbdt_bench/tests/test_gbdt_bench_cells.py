"""Cells, configurations, traffic mixes and metrics are found by name."""
import json
import re

import pytest

from conftest import BENCH
from harness import cells

BENCHMARK = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = cells.cell(name)
    assert cell.chips in (1, 4)
    assert cells.module("datagen", cell.config["generator"]).make
    driver = cells.module("drivers", cell.traffic["driver"])
    assert driver.run and driver.judge_data
    assert cell.limits, "each cell holds the limits of its check"
    reported = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "iter_s"} <= reported
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(cells.module("metrics", metric).read)


@pytest.mark.parametrize("bad", ["no-such-cell", "../configs/higgs",
                                 "higgs leaf", ""])
def test_unknown_name_refused(bad):
    with pytest.raises(cells.UnknownName):
        cells.cell(bad)


@pytest.mark.parametrize("kind,bad", [("configs", "nope"),
                                      ("traffic", "../BENCHMARK"),
                                      ("metrics", "os")])
def test_unknown_part_refused(kind, bad):
    with pytest.raises(cells.UnknownName):
        if kind == "metrics":
            cells.module(kind, bad)
        else:
            cells.part(kind, bad)


def test_benchmark_names_and_files():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCHMARK["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCHMARK["configs"]:
        assert (BENCH.parent / c["file"]).is_file()
        assert c["file"].startswith(BENCHMARK["paths"][0] + "/")
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == {c["name"] for c in BENCHMARK["configs"]}
    assert {m["name"] for m in BENCHMARK["end_to_end"]} >= {"setup_s"}
    for m in BENCHMARK["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
