"""The watchdog's abort (``resilience.Watchdog`` with ``abort=True``, what
``train(..., watchdog_timeout_s>0)`` arms) in a child process on the CPU:
a ``train()`` callback sleeps past the timeout inside a watched section, and
the watchdog, not a ``SystemExit`` the caller could catch, ends the child
with ``EXIT_STALLED`` (79) after writing its artifact beside the checkpoint
prefix.  The artifact names the section, holds ``stall_s`` >= the timeout,
the miss counts (``recompiles``) and the kernels' launches; its keys are the
JAX watchdog's, apart from ``devices`` and what is JAX's own
(``process_index``) or the port's own (``launches``,
``kernel_build_s``).  The child runs in a session of its own, and no
process of that session outlives it.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from lightgbm_tpu import resilience as jax_resilience
from lightgbm_tpu_torch import resilience

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 1.0
CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import resilience
timeout, prefix = float(sys.argv[2]), sys.argv[3]
rng = np.random.RandomState(0)
X = rng.normal(size=(1000, 6))
y = (X[:, 0] + rng.normal(scale=0.5, size=1000) > 0).astype(float)


def stall(env):
    with resilience.watch("stall_probe", iteration=env.iteration):
        time.sleep(60 * timeout)
stall.order = 30
try:
    lgb.train({"objective": "binary", "num_leaves": 7, "verbosity": -1,
               "watchdog_timeout_s": timeout}, lgb.Dataset(X, y),
              num_boost_round=3, callbacks=[stall], checkpoint_prefix=prefix,
              device="cpu")
except BaseException as exc:
    print("caught %r" % exc, flush=True)
    raise
print("not aborted", flush=True)
"""


def session_processes(sid: int) -> list:
    """PIDs of the processes of session ``sid`` (``/proc/<pid>/stat``)."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % name) as fh:
                stat = fh.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[3]) == sid:
            out.append(int(name))
    return out


@pytest.fixture(scope="module")
def aborted(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("wd") / "run")
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, ROOT, str(TIMEOUT_S), prefix],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    art = prefix + ".stall.json"
    with open(art) as fh:
        diag = json.load(fh)
    return dict(rc=proc.returncode, out=out, err=err, diag=diag,
                pid=proc.pid, seconds=time.perf_counter() - t)


def test_child_exits_stalled(aborted):
    assert aborted["rc"] == resilience.EXIT_STALLED == 79, aborted["err"]
    assert "caught" not in aborted["out"]
    assert "not aborted" not in aborted["out"]
    assert session_processes(aborted["pid"]) == []


def test_artifact_names_the_stall(aborted):
    d = aborted["diag"]
    assert d["kind"] == "watchdog_stall" and d["section"] == "stall_probe"
    assert d["info"] == {"iteration": 0}
    assert TIMEOUT_S <= d["stall_s"] < 30 * TIMEOUT_S
    assert d["timeout_s"] == TIMEOUT_S and d["pid"] == aborted["pid"]
    assert isinstance(d["recompiles"], dict)
    assert isinstance(d["launches"], dict) and d["devices"] == ["cpu"]


def test_artifact_keys_equal_jax():
    jax_diag = jax_resilience.Watchdog(TIMEOUT_S, abort=False)._diagnostics(
        "x", 2.0, {})
    diag = resilience.Watchdog(TIMEOUT_S, abort=False)._diagnostics(
        "x", 2.0, {})
    assert set(diag) - {"devices", "launches", "kernel_build_s"} == \
        set(jax_diag) - {"devices", "process_index"}
    assert "recompiles" in diag


def test_artifact_of_the_child_has_the_keys(aborted):
    want = set(resilience.Watchdog(TIMEOUT_S, abort=False)._diagnostics(
        "x", 2.0, {}))
    assert set(aborted["diag"]) == want
