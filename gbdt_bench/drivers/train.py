"""The training driver: one cell's set-up, measured window and outputs.

Set-up runs from process start to the first timed iteration: the imports,
the data made on the device from the seed, the program's binning
(``Dataset.construct``), and ``lightgbm_tpu_torch.train`` building its
booster and running ``WARMUP`` iterations.  The window is the same
``train`` call going on, whole iterations of its asynchronous
``Booster.update`` loop, until ``seconds`` have passed; it closes with every
pending tree materialised and the device synchronised.  A traced run
profiles the device alone over a window of ``TRACE_SECONDS``, closed with
the device synchronised, and then the host with it over a short window of
its own (``HOST_TRACE_SECONDS``).
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from harness import cells

# iterations run before the window: the first compiles and allocates
WARMUP = 2
# a traced run profiles the device alone over the first whole iterations of
# the window up to this many seconds (reading a 30-s leaf-wise window's
# events took minutes), then the host and the device together over whole
# iterations up to HOST_TRACE_SECONDS, only to name what the host did while
# the device sat idle: recording the host's operators slows a host-bound
# iteration about twice, so the device metrics never read that window
TRACE_SECONDS = 6.0
HOST_TRACE_SECONDS = 2.0


@dataclass
class Run:
    """What a run measured, and what the program produced, for the metric
    readers and the judge."""
    setup_s: float
    binning_s: float
    window_s: float
    iterations: int              # in the window
    peak_bytes: int
    n_rows: int
    trace: object = None         # the device window's (harness.profile.Trace)
    host_trace: object = None    # the host and device window's
    window_trees: list = field(default_factory=list)
    outputs: object = None       # reference.judge.Outputs
    extra: dict = field(default_factory=dict)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _profiler(activities):
    import torch.profiler as tp
    # the profiler's own start-up (its warm-up phase) runs over the
    # iteration before the one it records
    return tp.profile(activities=activities,
                      schedule=tp.schedule(wait=0, warmup=1, active=1 << 30))


class _Window:
    """A ``train`` callback: the warm-up's end starts the window, the first
    iteration ending past ``limit`` seconds closes it.  Traced, the window
    is the device profiler's; closing it starts the host profiler, and the
    first iteration past ``HOST_TRACE_SECONDS`` of that stops training."""
    order = 1000
    before_iteration = False

    def __init__(self, limit: float, device, profilers=None) -> None:
        self.limit, self.device = limit, device
        self.profilers = profilers        # (device window's, host window's)
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self.t_host: Optional[float] = None
        self.iterations = 0               # in the window
        self.driven = 0                   # in all
        self.host_from = 0                # the host window's first

    def __call__(self, env) -> None:
        from lightgbm_tpu_torch.callback import EarlyStopException
        done = self.driven = env.iteration - env.begin_iteration + 1
        prof = self.profilers
        if prof is not None and done == WARMUP - 1:
            prof[0].__enter__()
        if done == WARMUP:
            _sync(self.device)
            if prof is not None:
                prof[0].step()
            self.t_start = time.perf_counter()
            return
        if done < WARMUP:
            return
        if self.t_stop is None:
            self.iterations = done - WARMUP
            if time.perf_counter() - self.t_start < self.limit:
                return
            if prof is None:
                raise EarlyStopException(env.iteration, [])
            _sync(self.device)
            self.t_stop = time.perf_counter()
            prof[0].__exit__(None, None, None)
            prof[1].__enter__()
            self.host_from = done
        elif done == self.host_from + 1:
            prof[1].step()
            self.t_host = time.perf_counter()
        elif time.perf_counter() - self.t_host >= HOST_TRACE_SECONDS:
            raise EarlyStopException(env.iteration, [])


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, config=None) -> Run:
    """One run of a training cell on ``device``; ``config`` replaces the
    cell's configuration (the harness's tests run a small one)."""
    import lightgbm_tpu_torch as lgb
    from reference import judge as J
    from reference.model_text import parse_trees
    phases = {"imports": time.perf_counter() - t0}
    cfg = dict(cell.config if config is None else config)
    gen = cells.module("datagen", cfg["generator"])
    t = time.perf_counter()
    X, y, Xt, yt = gen.make(cfg, seed, device)
    X_np, y_np, Xt_np = X.cpu().numpy(), y.cpu().numpy(), Xt.cpu().numpy()
    del X, y, Xt, yt
    phases["data"] = time.perf_counter() - t
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = dict(cfg["params"])
    params.update(cell.traffic["params"])
    params["verbosity"] = -1
    t_b = time.perf_counter()
    ds = lgb.Dataset(X_np, label=y_np, params=params)
    ds.construct()
    binning_s = time.perf_counter() - t_b
    limit = min(seconds, TRACE_SECONDS) if trace else seconds
    profs = None
    if trace:
        cpu, cuda = (torch.profiler.ProfilerActivity.CPU,
                     torch.profiler.ProfilerActivity.CUDA)
        profs = (_profiler([cuda] if on_cuda else [cpu]),
                 _profiler([cpu, cuda] if on_cuda else [cpu]))
    clock = _Window(limit, device, profs)
    t = time.perf_counter()
    booster = lgb.train(params, ds, num_boost_round=1 << 30,
                        callbacks=[clock], verbose_eval=False, device=device)
    phases["binning"] = binning_s
    phases["booster_warmup"] = clock.t_start - t
    gbdt = booster._booster
    total = len(gbdt.models)          # materializes every pending tree
    _sync(device)
    t_end = time.perf_counter() if clock.t_stop is None else clock.t_stop
    traces = [None, None]
    if profs is not None:
        from harness import profile as P
        profs[1].__exit__(None, None, None)
        traces = [P.from_profiler(p) for p in profs]
        del profs
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    text = booster.model_to_string(num_iteration=total)
    trees = parse_trees(text)
    out = J.Outputs(
        bounds=[np.array(m.bin_upper_bound, dtype=np.float64)
                for m in ds.handle.bin_mappers],
        trees=trees, iterations=clock.driven,
        train_score=gbdt.train_score[0].detach().clone(),
        pred_test=torch.as_tensor(booster.predict(
            Xt_np, raw_score=True, num_iteration=total)))
    del booster, gbdt, ds
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    return Run(setup_s=clock.t_start - t0, binning_s=binning_s,
               window_s=t_end - clock.t_start, iterations=clock.iterations,
               peak_bytes=int(peak), n_rows=len(y_np),
               trace=traces[0], host_trace=traces[1],
               window_trees=trees[WARMUP:WARMUP + clock.iterations],
               outputs=out, extra={"setup_phases": phases})


def judge_data(cell: cells.Cell, seed: int, device, config=None):
    """The raw rows again, made from the seed, and the cell's settings for
    the reference."""
    from reference import gbdt as R
    from reference import judge as J
    cfg = dict(cell.config if config is None else config)
    prm = dict(cfg.get("defaults", {}))
    prm.update(cfg["params"])
    prm.update(cell.traffic["params"])
    X, y, Xt, _ = cells.module("datagen", cfg["generator"]).make(
        cfg, seed, device)
    return J.Data(
        X=X, y=y.cpu().numpy(), X_test=Xt,
        params=R.Params(
            num_leaves=int(prm["num_leaves"]),
            min_data_in_leaf=int(prm["min_data_in_leaf"]),
            min_sum_hessian_in_leaf=float(prm["min_sum_hessian_in_leaf"]),
            lambda_l2=float(prm["lambda_l2"]),
            min_gain_to_split=float(prm["min_gain_to_split"]),
            level=prm.get("tree_grow_mode", "leaf") == "level"),
        learning_rate=float(prm["learning_rate"]),
        max_bin=int(prm["max_bin"]),
        sample_cnt=int(prm["bin_construct_sample_cnt"]),
        data_random_seed=int(prm["data_random_seed"]),
        quantized=prm.get("hist_precision", "exact") == "quantized",
        quant_seed=int(prm["seed"]),
        min_data_in_bin=int(prm["min_data_in_bin"]))
