"""The reference's six override configs through the port, on the CPU.

``dart``, ``goss``, ``rf``, ``monotone``, ``forced_splits`` and
``sparse_binary`` (LibSVM) of ``tests/data``, trained as the CLI's
``task=train`` trains them (``test_torch_parity.run_config``) at
``test_parity.py``'s iteration counts and held to the reference LightGBM
2.3.2 CLI's metrics in ``golden_metrics.json`` within ``test_parity.py``'s
windows (:112-165).
"""
import pytest

from test_torch_parity import check_golden
from test_torch_quant import one_thread  # noqa: F401

CASES = {
    "dart": (25, {
        "training auc": 0.03, "valid_1 auc": 0.03,
        "training binary_logloss": 0.06, "valid_1 binary_logloss": 0.06}),
    "goss": (25, {
        "training auc": 0.03, "valid_1 auc": 0.03,
        "training binary_logloss": 0.05, "valid_1 binary_logloss": 0.05}),
    "rf": (25, {
        "training auc": 0.04, "valid_1 auc": 0.04,
        "training binary_logloss": 0.06, "valid_1 binary_logloss": 0.06}),
    "monotone": (25, {"training l2": 0.02, "valid_1 l2": 0.02}),
    "forced_splits": (25, {
        "training auc": 0.02, "valid_1 auc": 0.025,
        "training binary_logloss": 0.04, "valid_1 binary_logloss": 0.04}),
    "sparse_binary": (25, {
        "training auc": 0.02, "valid_1 auc": 0.03,
        "training binary_logloss": 0.04, "valid_1 binary_logloss": 0.05}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_windows(name, one_thread):
    check_golden(name, CASES)
