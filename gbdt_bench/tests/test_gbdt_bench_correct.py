"""``correct`` at a size the CPU holds: the program's run passes each
cell's limits; the reference put in its place in the next lower precision
(the control) fails them, and so does a run with the timed path broken
underneath (a step that leaves the state unchanged, half the rows left
out, an answer altered where it is produced).  One card, so no exchange
between chips can be left out."""
import time

import numpy as np
import pytest
import torch

from conftest import small_config
from harness import cells
from reference import judge as J
import run as RUN

CELLS = ["higgs-leaf", "higgs-level-quant", "epsilon-leaf", "epsilon-level"]


def _execute(name, seed=101):
    torch.set_num_threads(2)
    cell = cells.cell(name)
    res, checks, _ = RUN.execute(cell, seed, 1.0, False, "cpu",
                                 time.perf_counter(),
                                 config=small_config(cell, rows=8000))
    return res, checks


@pytest.mark.parametrize("name", CELLS)
def test_program_passes(name):
    res, checks = _execute(name)
    assert res["correct"], checks
    assert res["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = cells.cell(name)
    driver = cells.module("drivers", cell.traffic["driver"])
    data = driver.judge_data(cell, 202, "cpu",
                             config=small_config(cell, rows=8000))
    variant = "int4" if data.quantized else "bf16"
    nums = J.judge(data, J.train_reference(data, 3, variant))
    assert not J.verdict(nums, cell.limits), nums


def _skip_third_iteration(monkeypatch):
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    real = GBDT.train_one_iter

    def step(self, *a, **k):
        if self.iter_ == 2 and not getattr(self, "_skipped", False):
            self._skipped = True
            return False
        return real(self, *a, **k)
    monkeypatch.setattr(GBDT, "train_one_iter", step)


def _half_the_rows(monkeypatch):
    from lightgbm_tpu_torch.core import tree_learner as TL
    learner = TL.SerialTreeLearner
    real = learner.train

    def train(self, grad, hess, *a, **k):
        keep = torch.ones_like(grad)
        keep[1::2] = 0
        return real(self, grad * keep, hess * keep, *a, **k)
    monkeypatch.setattr(learner, "train", train)


def _alter_a_leaf(monkeypatch):
    from lightgbm_tpu_torch.boosting import gbdt as G
    real = G.tree_from_arrays

    def altered(arrays, *a, **k):
        tree = real(arrays, *a, **k)
        tree.leaf_value[0] += 0.5
        return tree
    monkeypatch.setattr(G, "tree_from_arrays", altered)


@pytest.mark.parametrize("fault", [_skip_third_iteration, _half_the_rows,
                                   _alter_a_leaf])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_fails(monkeypatch, fault, name):
    fault(monkeypatch)
    res, checks = _execute(name, seed=303)
    assert not res["correct"], checks
