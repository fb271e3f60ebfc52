"""A cell's parts, found by name: ``BENCHMARK.json`` at the checkout's root
names the cell's configuration and traffic mix and lists the metrics; the
files are ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (the limits of its correctness check),
``datagen/<generator>.py``, ``drivers/<driver>.py`` and
``metrics/<metric>.py``."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class UnknownName(LookupError):
    pass


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise UnknownName("not a name: %r" % (name,))
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def part(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = BENCH / kind / (_checked(name) + ".json")
    if not path.is_file():
        raise UnknownName("no %s named %r" % (kind.rstrip("s"), name))
    return load_json(path)


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder."""
    path = BENCH / kind / (_checked(name) + ".py")
    if not path.is_file():
        raise UnknownName("no %s module named %r" % (kind, name))
    key = "gbdt_bench_%s_%s" % (kind, re.sub(r"\W", "_", name))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; an unknown
    name raises :class:`UnknownName`."""
    bench = bench if bench is not None else benchmark()
    for w in bench["workloads"]:
        if w["name"] == _checked(name):
            break
    else:
        raise UnknownName("no workload named %r in BENCHMARK.json" % name)
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=part("configs", w["config"]), traffic_name=w["traffic"],
        traffic=part("traffic", w["traffic"]),
        limits=part("workloads", name).get("limits", {}),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
