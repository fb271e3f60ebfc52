"""On a card: a small run of each cell passes, and its control fails, the
same comparison as the cell's own runs (``control.py`` reads them at the
cells' sizes)."""
import time

import pytest
import torch

from conftest import small_config
from harness import cells
from reference import judge as J
import run as RUN


@pytest.mark.chip
@pytest.mark.parametrize("name", ["higgs-leaf", "higgs-level-quant",
                                  "epsilon-leaf", "epsilon-level"])
def test_small_run_and_control_on_card(need_card, name):
    cell = cells.cell(name)
    cfg = small_config(cell, rows=200000)
    res, checks, _ = RUN.execute(cell, 404, 2.0, False, "cuda",
                                 time.perf_counter(), config=cfg)
    assert res["correct"], checks
    driver = cells.module("drivers", cell.traffic["driver"])
    data = driver.judge_data(cell, 405, "cuda", config=cfg)
    variant = "int4" if data.quantized else "bf16"
    nums = J.judge(data, J.train_reference(data, 3, variant))
    assert not J.verdict(nums, cell.limits), nums
