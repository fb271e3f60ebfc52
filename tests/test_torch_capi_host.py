"""The C host program (``lightgbm_tpu_torch/capi_host.c``), compiled with
``gcc`` against ``lightgbm_tpu_torch_c_api.h`` and linked to
``lib_lightgbm_tpu_torch.so`` (``capi_build.build_host``), run as a native
process on the CPU (``LIGHTGBM_TPU_TORCH_DEVICE=cpu``): it trains from a
CSV file with a ``.weight`` side file through ``LGBM_DatasetCreateFromFile``,
``LGBM_BoosterCreate``, ``LGBM_BoosterUpdateOneIter`` and
``LGBM_BoosterSaveModel`` alone.  Its model text must equal the port's
``train()`` on the same file and parameters byte for byte, and its metrics
must lie within ``test_torch_parity.py``'s binary windows of
``lightgbm_tpu.train`` on the same rows.  2,000 rows x 6 features, 63 bins,
15 leaves.
"""
import os
import subprocess

import numpy as np
import pytest

import lightgbm_tpu as J
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import capi_build, c_api
from lightgbm_tpu_torch.metric.binary import weighted_auc
from test_torch_boosters import make_data
from test_torch_parity import CASES
from test_torch_quant import one_thread  # noqa: F401

ITERS = 4
PARAMS = ("objective=binary num_leaves=15 max_bin=63 learning_rate=0.1 "
          "metric=auc num_iterations=%d verbosity=-1" % ITERS)
# test_torch_parity.py's binary windows against the reference
WINDOWS = CASES["binary_classification"][1]


def write_csv(path, X, y, w):
    """The label first, then the features, in "%.6f", and ``w`` in the
    ``.weight`` side file the loader reads beside it."""
    np.savetxt(path, np.column_stack([y, X]), fmt="%.6f", delimiter=",")
    np.savetxt(path + ".weight", w, fmt="%.6f")
    return np.loadtxt(path, delimiter=",")[:, 1:]


@pytest.fixture(scope="module")
def hosted(tmp_path_factory):
    """The host program's run: its model text, the rows and labels it
    read, the weights, and its standard output."""
    tmp = tmp_path_factory.mktemp("capi_host")
    exe = capi_build.build_host(str(tmp / "capi"))
    X, y = make_data("binary")
    w = np.random.RandomState(3).uniform(0.5, 1.5, size=len(y)).round(6)
    data = str(tmp / "train.csv")
    Xf = write_csv(data, X, y, w)
    model = str(tmp / "model.txt")
    env = dict(os.environ, **{c_api.DEVICE_ENV: "cpu",
                              "OMP_NUM_THREADS": "1"})
    proc = subprocess.run([exe, data, PARAMS, str(ITERS), model],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(model) as fh:
        text = fh.read()
    return dict(exe=exe, data=data, text=text, X=Xf, y=y, w=w,
                stdout=proc.stdout)


def test_host_is_a_native_program(hosted):
    with open(hosted["exe"], "rb") as fh:
        assert fh.read(4) == b"\x7fELF"
    # its own lines among the library's log lines
    steps = [ln.split()[0] for ln in hosted["stdout"].splitlines()
             if ln.split()[:1] in (["load"], ["create"], ["iteration"],
                                   ["save"])]
    assert steps[:2] == ["load", "create"] and steps[-1] == "save"
    assert steps.count("iteration") == ITERS


def test_host_model_equals_port_train(hosted, one_thread):  # noqa: F811
    params = dict(tok.split("=", 1) for tok in PARAMS.split())
    ref = P.train(dict(params), P.Dataset(hosted["data"], params=params),
                  num_boost_round=ITERS, verbose_eval=False, device="cpu")
    assert hosted["text"] == ref.model_to_string()


def test_host_model_within_parity_of_jax(hosted):
    params = dict(objective="binary", num_leaves=15, max_bin=63,
                  learning_rate=0.1, verbosity=-1)
    X, y, w = hosted["X"], hosted["y"], hosted["w"]
    jb = J.train(params, J.Dataset(X, y, weight=w), num_boost_round=ITERS,
                 verbose_eval=False)
    host = P.Booster(model_str=hosted["text"], device="cpu")
    assert host.num_trees() == ITERS
    got, want = host.predict(X), np.asarray(jb.predict(X))
    eps = 1e-15
    for metric, value in (
            ("training auc", lambda p: weighted_auc(y, p, w)),
            ("training binary_logloss", lambda p: float(np.average(
                -y * np.log(np.clip(p, eps, 1)) - (1 - y)
                * np.log(np.clip(1 - p, eps, 1)), weights=w)))):
        assert abs(value(got) - value(want)) < WINDOWS[metric], metric


def test_host_reports_a_failing_call(tmp_path, hosted):
    env = dict(os.environ, **{c_api.DEVICE_ENV: "cpu"})
    proc = subprocess.run([hosted["exe"], str(tmp_path / "missing.csv"),
                           PARAMS, "1", str(tmp_path / "m.txt")],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 1
    assert "LGBM_DatasetCreateFromFile" in proc.stderr
    assert not os.path.exists(tmp_path / "m.txt")


def test_host_needs_a_shared_python(tmp_path, monkeypatch):
    real = capi_build.sysconfig.get_config_var
    monkeypatch.setattr(
        capi_build.sysconfig, "get_config_var",
        lambda k: 0 if k == "Py_ENABLE_SHARED" else real(k))
    with pytest.raises(capi_build.CapiBuildError, match="shared"):
        capi_build.build_host(str(tmp_path / "capi"))
    assert not os.path.exists(tmp_path / "capi")
