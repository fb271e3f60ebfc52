"""The port's spans (``lightgbm_tpu_torch/obs/spans.py``) on the CPU.

A span stamps its start and end with ``time.time_ns()``, the clock
``torch.profiler`` stamps host events with, so the operators a span issues
lie inside it in a profiler's trace; spans nest per thread; a collector
keeps exactly the spans closed while it is open; the spans at the training
loop's layer boundaries open as the layers run; and the spans that took the
place of the ``global_timer`` scopes feed those scopes under their
LightGBM names, with or without a sink.
"""
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import spans
from lightgbm_tpu_torch.utils.timer import global_timer

CPU = "cpu"
SCOPES = ("GBDT::Boosting", "TreeLearner::Train", "GBDT::UpdateScore")


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.disable()
    yield
    obs.disable()


def regression_data(n=600, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 5))
    return X, X[:, 0] + rng.normal(scale=0.1, size=n)


def train(rounds, **params):
    X, y = regression_data()
    return P.train(dict({"objective": "regression", "num_leaves": 7,
                         "min_data_in_leaf": 5, "verbosity": -1}, **params),
                   P.Dataset(X, y), rounds, device=CPU)


def test_span_stamps_the_profilers_clock():
    """The aten operators issued inside a span lie within its stamps in a
    CPU profiler window, and the span's named range lies there too."""
    x = torch.randn(256, 256)
    lo = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.collect() as got:
            with spans.span("outer_op"):
                y = x @ x
                y = torch.relu(y + 1.0)
    hi = time.time_ns()
    (rec,) = got
    assert rec.name == "outer_op"
    assert lo <= rec.t0_ns < rec.t1_ns <= hi
    events = prof.profiler.kineto_results.events()
    ops = [e for e in events if e.name() in ("aten::mm", "aten::relu",
                                             "aten::add")]
    assert len(ops) >= 3
    for e in ops:
        assert rec.t0_ns <= e.start_ns() <= e.end_ns() <= rec.t1_ns, e.name()
    ranges = [e for e in events if e.name() == "outer_op"]
    assert len(ranges) == 1
    assert rec.t0_ns <= ranges[0].start_ns() <= ranges[0].end_ns() \
        <= rec.t1_ns


def test_spans_nest_and_the_collector_keeps_what_closed_inside():
    with spans.span("before"):
        pass
    # with no sink a site is the shared no-op, even around a collector
    outside = spans.span("outside")
    seen = {}

    def worker():
        with spans.span("in_thread"):
            seen["tid"] = threading.get_native_id()

    with outside:
        with spans.collect() as got:
            with spans.span("root") as root:
                with spans.step("child") as child:
                    with spans.span("grandchild"):
                        pass
                t = threading.Thread(target=worker)
                t.start()
                t.join(10)
                assert not t.is_alive()
            assert isinstance(root, spans.Span)
            assert isinstance(child, spans.Span)
        with spans.span("after"):
            pass
    assert [r.name for r in got] == ["grandchild", "child", "in_thread",
                                     "root"]
    by = {r.name: r for r in got}
    assert by["grandchild"].parent == by["child"].seq
    assert by["child"].parent == by["root"].seq
    assert by["root"].parent is None
    # each thread keeps its own stack
    assert by["in_thread"].parent is None
    assert by["in_thread"].thread == seen["tid"]
    me = threading.get_native_id()
    assert all(by[n].thread == me for n in by if n != "in_thread")
    assert by["root"].seq < by["child"].seq < by["grandchild"].seq
    assert by["root"].t0_ns <= by["child"].t0_ns <= by["grandchild"].t0_ns \
        <= by["grandchild"].t1_ns <= by["child"].t1_ns <= by["root"].t1_ns
    # closed again: sites are shared no-ops, and collectors do not nest
    assert spans.span("x") is spans.span("y", k=1) is spans.step("z")
    with spans.collect():
        with pytest.raises(RuntimeError):
            with spans.collect():
                pass


def test_step_spans_reach_the_collector_only(tmp_path):
    from lightgbm_tpu_torch.obs.registry import read_events
    path = str(tmp_path / "t.jsonl")
    obs.configure(out=path, freq=1)
    assert spans.step("split_scan") is spans.step("split_pass")
    with spans.collect() as got:
        with spans.span("tree_build"):
            with spans.step("split_scan"):
                pass
    obs.disable()
    names = [e["name"] for e in read_events(path) if e["kind"] == "span"]
    assert names == ["tree_build"]
    assert [r.name for r in got] == ["split_scan", "tree_build"]


def test_training_opens_a_span_at_each_layer():
    """A leaf-wise and a level-wise CPU train inside a collector: the
    layers' spans, each inside the one the loop opens it in."""
    with spans.collect() as got:
        b = train(17)
        b.model_to_string()
    names = [r.name for r in got]
    for n in ("iteration", "objective", "tree_build", "split_scan",
              "split_pass", "tree_finish", "score_update", "stall_poll",
              "materialize"):
        assert n in names, n
    by_seq = {r.seq: r for r in got}

    def parent(r):
        return None if r.parent is None else by_seq[r.parent].name

    assert names.count("iteration") == 17
    assert names.count("tree_build") == 17
    # 6 splits a tree of 7 leaves, one scan each, and the root's
    assert names.count("split_scan") == 17 * 7
    assert names.count("split_pass") == 17 * (1 + 6)
    for r in got:
        want = {"objective": "iteration", "tree_build": "iteration",
                "score_update": "iteration", "tree_finish": "tree_build",
                "split_scan": "tree_build", "split_pass": "tree_build",
                "stall_poll": "iteration"}.get(r.name)
        if want is not None:
            assert parent(r) == want, r
    with spans.collect() as got:
        train(2, tree_grow_mode="level", max_depth=3, num_leaves=8)
    names = [r.name for r in got]
    # the root's pass and scan, then a pass and a scan each of 3 levels
    assert names.count("split_pass") == 2 * 4
    assert names.count("split_scan") == 2 * 4


@pytest.mark.parametrize("collecting", [False, True],
                         ids=["no_sink", "collector"])
def test_global_timer_scopes_after_a_cpu_train(collecting):
    """The spans that took the place of ``FunctionTimer`` scopes feed
    ``global_timer`` under the scopes' names, with a sink and without."""
    global_timer.reset()
    if collecting:
        with spans.collect():
            train(3)
    else:
        train(3)
    totals = global_timer.totals()
    for name in SCOPES + ("GBDT::Bagging",):
        assert totals.get(name, 0) > 0, name
    global_timer.reset()
    assert global_timer.totals() == {}


def test_layer_attribution_rule():
    """``probes/layer_spans.py``'s rule on a synthetic window: a kernel
    goes to the innermost span open on its launching thread at its launch
    record's host start, an idle gap to the innermost span open on the
    training thread at its middle; no launch record, no attribution."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "probes" / "layer_spans.py"
    spec = importlib.util.spec_from_file_location("layer_spans_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    R = spans.SpanRecord
    main, other = 11, 22
    recs = [R("objective", 5, 10, 0, main, 1),
            R("split_scan", 30, 40, 2, main, 3),
            R("split_pass", 50, 60, 2, main, 4),
            R("tree_finish", 80, 88, 2, main, 5),
            R("tree_build", 20, 90, 0, main, 2),
            R("iteration", 0, 100, None, main, 0),
            R("elsewhere", 0, 100, None, other, 6)]
    launches = {1: (7, main), 2: (35, main), 3: (55, main), 4: (70, main),
                5: (85, main), 6: (95, main), 7: (150, main),
                9: (35, other), 10: (57, 0)}
    kernels = [("elementwise", 1000, 1), ("cumsum", 2000, 2),
               ("hist_seg_kernel", 4000, 3), ("gather", 8000, 4),
               ("cummax", 16000, 5), ("add", 32000, 6), ("fill", 64000, 7),
               ("copy", 128000, 8), ("sort", 256000, 9),
               ("part_scatter_kernel", 512000, 10)]
    where = probe.innermost(recs, [(7, main), (35, main), (35, other),
                                   (95, main), (150, main), (20, main)])
    assert where == ["objective", "split_scan", "elsewhere", "iteration",
                     None, "tree_build"]
    a = probe.attribute(kernels, launches, recs, [(6, 8), (100, 200)],
                        main, lambda n: n.startswith(("hist_", "part_")), 2)
    assert a["objective_ms_per_iter"] == pytest.approx(1000e-6 / 2)
    assert a["split_scan_ms_per_iter"] == pytest.approx(2000e-6 / 2)
    assert a["split_scan_launches_per_iter"] == 0.5
    assert a["growth_ms_per_iter"] == pytest.approx(24000e-6 / 2)
    assert a["growth_launches_per_iter"] == 1.0
    # the gap at 7 lies in ``objective``; the one at 150 in no span
    assert a["idle_in_spans_pct"] == pytest.approx(100.0 * 2 / 102)
    # 10 kernels: one past every span, one without a launch record
    assert a["kernels_in_spans_pct"] == pytest.approx(80.0)
    # a launch record without a thread is the training thread's
    assert a["port_in_split_pass_pct"] == 100.0
    by = a["torch_ops_by_span_ms_per_iter"]
    assert by["elsewhere"] == pytest.approx(256000e-6 / 2)
    assert by["(no span)"] == pytest.approx(64000e-6 / 2)
    assert by["(no launch record)"] == pytest.approx(128000e-6 / 2)
    assert sum(by.values()) == pytest.approx(
        sum(d for n, d, _ in kernels if not n.startswith(("hist_", "part_")))
        * 1e-6 / 2)
    assert probe.attribute(kernels, {}, recs, [], main, lambda n: False,
                           2) is None
    assert probe.window_host_ms(recs, 0, 1) == pytest.approx(70e-6)
