"""Without a card the harness fails and prints no result; device metrics
have no CPU fallback."""
import json
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH
from harness import cells, chip
from harness.profile import Trace

ARGS = ["--workload", "higgs-leaf", "--seed", "2147483659", "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "gbdt_bench/run.py"] + ARGS,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(BENCH.parent, env)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_require_cards_raises_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(chip.NoCard):
        chip.require_cards(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(chip.NoCard):
        chip.require_cards(4)


def test_benchmark_alone_fails(tmp_path):
    # a directory with BENCHMARK.json and the benchmark's files only
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "gbdt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


class _Run:
    trace = Trace()
    iterations = 3
    window_s = 1.0
    window_trees = ["a tree"]
    n_rows = 10


@pytest.mark.parametrize("metric", ["launches_per_iter",
                                    "torch_ops_ms_per_iter",
                                    "kernels_roofline_pct",
                                    "device_idle_pct", "step_mfu_pct"])
def test_device_metrics_read_nothing_without_device_events(metric):
    ctx = {"run": _Run(), "num_bins": [255], "precision": "exact"}
    assert cells.module("metrics", metric).read(ctx) is None
