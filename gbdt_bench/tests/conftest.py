"""The harness's own tests, on the CPU at small sizes; those that need a
card are marked ``chip`` and skip without one (decided inside the test).

    python -m pytest gbdt_bench/tests -q
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips on the CPU")


def small_config(cell, rows=20000, features=None):
    """The cell's configuration cut to a size the CPU trains in seconds."""
    cfg = dict(cell.config)
    cfg["rows"], cfg["test_rows"] = rows, 2000
    cfg["features"] = features or min(cfg["features"], 40)
    cfg["params"] = dict(cfg["params"], num_leaves=31)
    if "bin_construct_sample_cnt" in cfg["params"]:
        cfg["params"]["bin_construct_sample_cnt"] = 5000
    return cfg


@pytest.fixture
def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
