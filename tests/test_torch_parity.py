"""The reference's own example configs through the port, on the CPU.

The four examples of ``tests/data`` here, the six override configs in
``test_torch_parity_modes.py``.  Each config is trained by the port exactly as ``Application``'s
``task=train`` trains them (``io.loader.DatasetLoader``, the boosting of
``boosting=``, training metrics and the validation file), at
``test_parity.py``'s iteration counts, and held to the reference LightGBM
2.3.2 CLI's metrics in ``golden_metrics.json`` within ``test_parity.py``'s
windows (:71-165).  The four examples (binary, regression, multiclass,
lambdarank) are also held to the JAX package's own metrics on the same
config (``test_parity.run_config``): regression and lambdarank within 1e-6
(their bags are the JAX package's, byte for byte); binary and multiclass
within the golden windows.  Those two part from the JAX package at a
near-tied split, whose gains differ by f32 rounding (multiclass: tree 0,
node 29, feature 0 at 7.97335 against feature 25 at 7.97341), and the
trees after it differ (ROADMAP queue 3).
"""
import functools
import os

import pytest

from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.config import Config, parse_config_file
from lightgbm_tpu_torch.io.loader import DatasetLoader
from lightgbm_tpu_torch.metric.metric import create_metrics
from lightgbm_tpu_torch.objective import create_objective
from test_parity import GOLDEN, check
from test_parity import run_config as jax_run_config
from test_torch_quant import one_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")


@functools.lru_cache(maxsize=None)
def run_config(name: str, num_iterations: int):
    """Train tests/data/<name>/train.conf as the CLI does, on the CPU."""
    conf_dir = os.path.join(DATA, name)
    params = parse_config_file(os.path.join(conf_dir, "train.conf"))
    params["num_iterations"] = str(num_iterations)
    params.pop("output_model", None)
    for key in ("data", "valid_data", "forcedsplits_filename"):
        if key in params:
            params[key] = os.path.join(conf_dir, params[key])
    cfg = Config(params)
    loader = DatasetLoader(cfg)
    train_data = loader.load_from_file(cfg.data)
    objective = create_objective(cfg.objective, cfg, device="cpu")
    booster = create_boosting(cfg.boosting, cfg, train_data, objective,
                              device="cpu")
    booster.add_train_metrics(create_metrics(cfg.metric, cfg))
    for valid_file in cfg.valid or []:
        valid = loader.load_from_file(valid_file, reference=train_data)
        booster.add_valid_data(valid, "valid_1",
                               create_metrics(cfg.metric, cfg))
    booster.train()
    return {"%s %s" % (ds, metric): val
            for ds, metric, val, _ in booster.eval_train()
            + booster.eval_valid()}


# test_parity.py's iteration counts and windows, config by config
CASES = {
    "binary_classification": (25, {
        "training auc": 0.02, "valid_1 auc": 0.025,
        "training binary_logloss": 0.04, "valid_1 binary_logloss": 0.04}),
    "regression": (25, {"training l2": 0.02, "valid_1 l2": 0.02}),
    "multiclass_classification": (10, {
        "training multi_logloss": 0.06, "valid_1 multi_logloss": 0.08,
        "training auc_mu": 0.03, "valid_1 auc_mu": 0.05}),
    "lambdarank": (10, {
        "training ndcg@5": 0.04, "valid_1 ndcg@5": 0.08,
        "training ndcg@1": 0.05, "valid_1 ndcg@1": 0.08}),
}
EXAMPLES = sorted(CASES)
EXACT = ("regression", "lambdarank")


def check_golden(name, cases):
    it, windows = cases[name]
    assert str(it) in GOLDEN[name]
    check(name, dict(run_config(name, it)), it, windows)


@pytest.mark.parametrize("name", EXAMPLES)
def test_golden_windows(name, one_thread):
    check_golden(name, CASES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_match_jax(name, one_thread):
    it, windows = CASES[name]
    got = dict(run_config(name, it))
    want = jax_run_config(name, it)
    assert sorted(got) == sorted(want)
    if name in EXACT:
        for key in want:
            assert abs(got[key] - want[key]) < 1e-6, (key, got[key],
                                                      want[key])
    else:
        for key, tol in windows.items():
            assert abs(got[key] - want[key]) < tol, (key, got[key],
                                                     want[key])

