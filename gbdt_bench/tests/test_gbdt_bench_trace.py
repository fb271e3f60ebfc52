"""A traced run on the CPU: the device window and the host window follow
each other inside one ``train`` call, the model holds every iteration both
drove, and the metrics read only the device window."""
import time

import torch

from conftest import small_config
from drivers import train as T
from harness import cells
import run as RUN


def test_traced_run_takes_two_windows():
    torch.set_num_threads(2)
    cell = cells.cell("higgs-leaf")
    res, checks, run = RUN.execute(cell, 11, 1.0, True, "cpu",
                                   time.perf_counter(),
                                   config=small_config(cell, rows=8000))
    assert res["correct"], checks
    assert run.trace is not None and run.host_trace is not None
    assert run.host_trace.host, "the host window recorded no operation"
    assert res["attempted"] == run.iterations >= 1
    assert len(run.window_trees) == run.iterations
    assert run.window_s < 1.0 + T.HOST_TRACE_SECONDS
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
