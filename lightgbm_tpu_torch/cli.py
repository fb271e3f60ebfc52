"""Command-line application: ``python -m lightgbm_tpu_torch config=train.conf``.

The counterpart of ``lightgbm_tpu/cli.py`` for the PyTorch port (which
imports nothing of the JAX package), and of the reference CLI (src/main.cpp,
src/application/application.cpp): parameter precedence argv ``key=value``
over config-file lines (:49-82), the tasks ``train``, ``predict``,
``convert_model`` and ``refit`` (:204-260), evaluation every
``metric_freq`` iterations, snapshots, and the ``LightGBM_predict_result.txt``
format (predictor.hpp).  ``task=train`` trains through ``GBDT.train``, in
fused chunks cut at ``metric_freq`` and ``snapshot_freq`` (gbdt.py:1843-1900
of the JAX package).  ``task=train`` with ``snapshot_freq`` or
``preemption_checkpoint=true`` resumes an interrupted run of the same
command from its newest valid checkpoint and removes its checkpoints when it
completes (``checkpoint.py``).  With ``preemption_checkpoint=true``, SIGTERM
or SIGINT makes ``task=train`` write an emergency checkpoint at the next
chunk boundary and exit with code 75 (``resilience.EXIT_PREEMPTED``);
``watchdog_timeout_s`` aborts a stalled chunk with code 79
(cli.py:147-280 of the JAX package).  Under an initialized
``torch.distributed`` group each process loads as its rank (``num_machines``
is the group's size, with a warning when the key says otherwise) and rank 0
alone writes the model; training from a rank's stripe of the rows is ROADMAP
item 13b (a gap of the JAX package), so a parallel ``tree_learner`` refuses
a striped load.

Device rule: :class:`Application` and :func:`main` run on ``cuda`` and raise
without it, unless the caller passes ``device="cpu"``; ``python -m
lightgbm_tpu_torch`` runs on ``cuda``.  LightGBM's ``device_type`` key is
not read for this (its upstream default is ``cpu``).

``task=serve`` (cli.py:337-425 of the JAX package) scores ``data`` through
the serving tier: every row (every 256-row block past 8,192 rows) is one
request, coalesced by the scheduler, and the output has
``task=predict``'s format; it equals ``task=predict``'s line for line from
512 rows on (below that ``task=predict`` takes the f64 regime).
``telemetry_out`` and ``metrics_port`` make any task record a telemetry
run (``obs``), finalized into ``<telemetry_out>.summary.json``.
``alert_rules`` and ``flight_recorder`` ride that run (``obs/alerts.py``,
``obs/profiling.py``); ``plan_cache`` engages the kernel planner's tuned
plans for every task (``plan/``, cli.py:81-86 of the JAX package).
``task=online`` (cli.py:425-525) bootstraps or loads a model over ``data``,
serves it while a trainer thread continues it (``online``), replays
``online_feed`` (a labeled file binned against the training layout) as
both requests and trainer ingest, writes the scores to ``output_result``
in request order and each published generation to ``output_model``; a
SIGTERM exits 75 and the same command again resumes the cycle.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import obs, resilience
from .boosting import create_boosting
from .boosting.gbdt import GBDT
from .checkpoint import (cleanup_checkpoints, load_latest_checkpoint,
                         restore_state)
from .config import Config, parse_config_file
from .device import DeviceLike, resolve_device
from .io.loader import DatasetLoader
from .metric.metric import create_metrics
from .objective import create_objective
from .parallel.distdata import pod_info
from .parallel.learners import is_write_leader
from .utils.log import Log
from .utils.timer import global_timer


def parse_args(argv: List[str]) -> Dict[str, str]:
    """argv ``k=v`` pairs + optional ``config=file`` (application.cpp:49-82);
    command-line values win over config-file values."""
    params: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            Log.warning("Unknown argument %s", arg)
            continue
        k, v = arg.split("=", 1)
        params[k.strip()] = v.strip()
    if "config" in params:
        file_params = parse_config_file(params.pop("config"))
        for k, v in file_params.items():
            params.setdefault(k, v)
    return params


class Application:
    """CLI application (src/application/application.h) on ``device``."""

    def __init__(self, argv: List[str], device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.params = parse_args(argv)
        self.config = Config(self.params)
        Log.reset_level(Log.level_from_verbosity(int(self.config.verbosity)))
        # the tuned-plan cache (plan_cache, else the default path): absent
        # means analytic plans, unusable means analytic with one warning
        # and the plan_cache_fallbacks counter
        from .plan import state as _plan_state
        _plan_state.configure_from_config(self.config)

    def run(self) -> None:
        task = self.config.task
        if task == "train":
            self.train()
        elif task in ("predict", "prediction", "test"):
            self._with_telemetry(self.predict)
        elif task == "serve":
            self._with_telemetry(self.serve)
        elif task == "online":
            self.online()
        elif task == "convert_model":
            self.convert_model()
        elif task == "refit":
            self.refit()
        else:
            Log.fatal("Unknown task: %s", task)

    def _with_telemetry(self, task) -> None:
        """Run ``task()`` inside the telemetry run the config asks for
        (cli.py:107-145 of the JAX package); ``task`` returns the extra
        summary fields, and the run is finalized and closed after it (and
        closed, unfinalized, when it raises)."""
        tele = obs.configure_from_config(self.config, "cli",
                                         task=str(self.config.task))
        try:
            extra = task()
            if tele is not None:
                from .obs.report import finalize_run
                finalize_run(tele, gbdt=getattr(self, "booster", None)
                             if self.config.task in ("train", "online")
                             else None, extra=extra)
        finally:
            if tele is not None and obs.active() is tele:
                obs.disable()

    # ---- task=train (application.cpp:84-213) ----

    def train(self) -> None:
        cfg = self.config
        owned = resilience.arm_supervision(
            bool(cfg.preemption_checkpoint), float(cfg.watchdog_timeout_s),
            artifact_base=(str(cfg.telemetry_out or "")
                           or cfg.output_model or None))
        try:
            self._with_telemetry(self._train)
        except resilience.TrainingPreempted as exc:
            # the emergency checkpoint is on disk: the distinct exit code
            # tells a supervisor to rerun this command, which resumes
            Log.warning("%s; exiting with code %d (resumable)", exc,
                        resilience.EXIT_PREEMPTED)
            raise SystemExit(resilience.EXIT_PREEMPTED)
        finally:
            resilience.disarm_supervision(*owned)

    def _train(self) -> None:
        cfg = self.config
        loader = DatasetLoader(cfg)
        num_machines = max(int(cfg.num_machines), 1)
        # rank resolution (cli.py:176-188): under torch.distributed each
        # process loads as its rank (a row stripe unless pre_partition); a
        # single process keeps rank 0
        rank, pod = pod_info()
        if pod > 1:
            if num_machines > 1 and num_machines != pod:
                Log.warning("num_machines=%d but the torch.distributed "
                            "group has %d processes; using the group size",
                            num_machines, pod)
            num_machines = pod
        else:
            rank = 0
        train_data = loader.load_from_file(cfg.data, rank, num_machines)
        Log.info("Finished loading data: %d rows, %d features",
                 train_data.num_data, train_data.num_features)
        objective = create_objective(cfg.objective, cfg, device=self.device)
        booster = create_boosting(cfg.boosting, cfg, train_data, objective,
                                  device=self.device)
        # a previous run of this command that left a checkpoint is resumed
        # (the newest valid one); the restore waits for the validation sets,
        # whose scores ride the checkpoint
        ckpt_state = None
        resumable = ((cfg.snapshot_freq > 0 or cfg.preemption_checkpoint)
                     and bool(cfg.output_model))
        if resumable:
            ckpt_state = load_latest_checkpoint(cfg.output_model)
        if ckpt_state is None and cfg.input_model:
            with open(cfg.input_model) as fh:
                booster.load_model_from_string(fh.read())
            booster.reset_training_data(train_data, objective)
            booster.replay_train_score()
        if cfg.is_provide_training_metric:
            booster.add_train_metrics(create_metrics(cfg.metric, cfg))
        for i, valid_file in enumerate(cfg.valid or []):
            valid = loader.load_from_file(valid_file, reference=train_data)
            booster.add_valid_data(valid, "valid_%d" % (i + 1),
                                   create_metrics(cfg.metric, cfg))
        if ckpt_state is not None:
            restore_state(booster, ckpt_state)
        booster.train(snapshot_out=cfg.output_model)
        if is_write_leader(booster.group):
            # rank 0 alone writes the model and removes the checkpoints
            # (cli.py:249-258)
            booster.save_model(cfg.output_model)
            if resumable:
                # the run completed: a rerun of this command trains afresh
                cleanup_checkpoints(cfg.output_model)
        self.booster = booster
        if cfg.verbosity > 0:
            global_timer.print()

    # ---- task=predict (application.cpp:215-252, predictor.hpp) ----

    @staticmethod
    def _write_result(path: str, out) -> None:
        """The LightGBM_predict_result.txt format (predictor.hpp)."""
        with open(path, "w") as fh:
            for row in np.atleast_1d(out):
                if np.ndim(row) == 0:
                    fh.write("%g\n" % row)
                else:
                    fh.write("\t".join("%g" % v for v in row) + "\n")

    def predict(self) -> None:
        cfg = self.config
        if not cfg.input_model:
            Log.fatal("Need input_model for prediction task")
        booster = GBDT.load_model(cfg.input_model, cfg, device=self.device)
        X = DatasetLoader(cfg).load_prediction_data(cfg.data)
        num_iter = int(cfg.num_iteration_predict)
        precision = str(cfg.predict_precision)
        if cfg.predict_leaf_index:
            out = booster.predict_leaf_index(X, num_iter)
        elif cfg.predict_contrib:
            if precision != "exact":
                Log.fatal("predict_contrib has no bf16 tier: "
                          "predict_precision must be exact")
            out = booster.predict_contrib(X, num_iter)
        else:
            out = booster.predict(X, raw_score=bool(cfg.predict_raw_score),
                                  num_iteration=num_iter,
                                  precision=precision)
        self._write_result(cfg.output_result, out)
        Log.info("Finished prediction, wrote results to %s",
                 cfg.output_result)
        return {"rows_predicted": int(len(X))}

    # ---- task=serve (the serving tier over task=predict's data) ----

    def serve(self) -> Dict:
        """Score ``data`` through the serving tier (cli.py:337-425 of the
        JAX package) into ``output_result`` in ``task=predict``'s format;
        ``predict_contrib=true`` serves contributions.  Returns the
        summary's extra fields."""
        cfg = self.config
        if not cfg.input_model:
            Log.fatal("Need input_model for serve task")
        if cfg.predict_leaf_index:
            Log.fatal("task=serve serves scores and pred_contrib; "
                      "predict_leaf_index is not supported: use "
                      "task=predict")
        contrib = bool(cfg.predict_contrib)
        precision = str(cfg.predict_precision)
        if contrib and precision != "exact":
            Log.fatal("predict_contrib has no bf16 tier: "
                      "predict_precision must be exact")
        from .serving import Server
        t_start = time.perf_counter()
        booster = GBDT.load_model(cfg.input_model, cfg, device=self.device)
        X = DatasetLoader(cfg).load_prediction_data(cfg.data)
        server = Server(config=cfg, device=self.device)
        try:
            server.register("model", booster)
            # single-row requests exercise the coalescer (and the fast path
            # with serve_single_row_fast=true); large files go in
            # micro-batches so the replay stays O(batches) host work
            step = 1 if len(X) <= 8192 else 256
            futures = [server.submit(
                "model", X[lo:lo + step],
                raw_score=bool(cfg.predict_raw_score),
                num_iteration=int(cfg.num_iteration_predict),
                pred_contrib=contrib, precision=precision)
                for lo in range(0, len(X), step)]
            outs = [f.result() for f in futures]
        finally:
            server.close()
        stats = server.stats()
        if stats["dropped"]:
            Log.fatal("serving replay dropped %d requests", stats["dropped"])
        out = (np.concatenate([np.atleast_1d(o) for o in outs])
               if outs else np.zeros(0))
        self._write_result(cfg.output_result, out)
        Log.info("Served %d rows in %d requests / %d batches (single-row "
                 "fast: %d), wrote results to %s", len(X),
                 stats["submitted"], stats["batches"],
                 stats["single_row_fast"], cfg.output_result)
        return {"rows_served": int(len(X)),
                "serve_requests": int(stats["submitted"]),
                "serve_batches": int(stats["batches"]),
                "serve_wall_s": time.perf_counter() - t_start}

    # ---- task=online (the train-while-serve loop) ----

    def online(self) -> None:
        """Serve and train in one process (cli.py:427-524 of the JAX
        package); a preempted trainer exits 75 after serving drains."""
        cfg = self.config
        owned = resilience.arm_supervision(
            bool(cfg.preemption_checkpoint), float(cfg.watchdog_timeout_s),
            artifact_base=(str(cfg.telemetry_out or "")
                           or cfg.output_model or None))
        try:
            self._with_telemetry(self._online)
        except resilience.TrainingPreempted as exc:
            Log.warning("%s; exiting with code %d (resumable)", exc,
                        resilience.EXIT_PREEMPTED)
            raise SystemExit(resilience.EXIT_PREEMPTED)
        finally:
            resilience.disarm_supervision(*owned)

    def _online(self) -> Dict:
        from .online import OnlineController
        from .serving import Server
        cfg = self.config
        loader = DatasetLoader(cfg)
        train_data = loader.load_from_file(cfg.data)
        Log.info("Finished loading data: %d rows, %d features",
                 train_data.num_data, train_data.num_features)
        objective = create_objective(cfg.objective, cfg, device=self.device)
        booster = create_boosting(cfg.boosting, cfg, train_data, objective,
                                  device=self.device)
        if cfg.input_model:
            # the controller's warm-start binding replays the loaded model
            # onto the training scores and aligns the clock
            with open(cfg.input_model) as fh:
                booster.load_model_from_string(fh.read())
        else:
            booster.train()     # the bootstrap: num_iterations rounds
        self.booster = booster
        prefix = cfg.output_model or None
        server = Server(config=cfg, device=self.device)
        controller = None
        try:
            controller = OnlineController(
                server=server, name="model", booster=booster,
                base_ds=train_data, config=cfg, checkpoint_prefix=prefix,
                publish_out=prefix)
            controller.start()
            futures = []
            if cfg.online_feed:
                feed = loader.load_from_file(cfg.online_feed,
                                             reference=train_data)
                if feed.raw_data is None:
                    Log.fatal("online_feed must load with raw values "
                              "(dense input) to replay as requests")
                Xf = np.asarray(feed.raw_data, dtype=np.float32)
                yf = np.asarray(feed.metadata.label, dtype=np.float64)
                step = max(1, min(256, len(Xf) // 8 or 1))
                for lo in range(0, len(Xf), step):
                    if controller.preempted is not None:
                        break
                    futures.append(controller.submit(
                        Xf[lo:lo + step],
                        raw_score=bool(cfg.predict_raw_score)))
                    controller.ingest(Xf[lo:lo + step].astype(np.float64),
                                      yf[lo:lo + step])
                controller.flush(timeout=600.0)
            outs = [f.result() for f in futures]
            # raises the TrainingPreempted the trainer thread caught, once
            # serving has answered every accepted request
            controller.wait(timeout=0.0)
            out = (np.concatenate([np.atleast_1d(o) for o in outs])
                   if outs else np.zeros(0))
            self._write_result(cfg.output_result, out)
            st = controller.stats()
        finally:
            if controller is not None:
                controller.close()
            else:
                server.close(drain=False)
        if st["serving"]["dropped"]:
            Log.fatal("online replay dropped %d requests",
                      st["serving"]["dropped"])
        Log.info("Online run: %d cycles (generation %d), %d rows ingested, "
                 "%d requests served, results in %s", st["cycles"],
                 st["generation"], st["rows_ingested"],
                 st["serving"]["submitted"], cfg.output_result)
        self.booster = controller.booster
        return {"online_cli": st["cycles"]}

    # ---- task=convert_model (gbdt_model_text.cpp:87 ModelToIfElse) ----

    def convert_model(self) -> None:
        cfg = self.config
        if not cfg.input_model:
            Log.fatal("Need input_model for convert_model task")
        booster = GBDT.load_model(cfg.input_model, cfg, device=self.device)
        from .model_codegen import model_to_cpp
        out = cfg.convert_model or "gbdt_prediction.cpp"
        with open(out, "w") as fh:
            fh.write(model_to_cpp(booster))
        Log.info("Wrote converted model to %s", out)

    # ---- task=refit (application.cpp:216-252 + gbdt.cpp:299 RefitTree) ----

    def refit(self) -> None:
        cfg = self.config
        if not cfg.input_model:
            Log.fatal("Need input_model for refit task")
        train_data = DatasetLoader(cfg).load_from_file(cfg.data)
        objective = create_objective(cfg.objective, cfg, device=self.device)
        booster = create_boosting(cfg.boosting, cfg, train_data, objective,
                                  device=self.device)
        with open(cfg.input_model) as fh:
            booster.load_model_from_string(fh.read())
        booster.reset_training_data(train_data, objective)
        if train_data.raw_data is not None:
            # raw values: each node routes by v <= thr, as the reference's
            # RefitTree does for any model
            leaf_preds = booster.predict_leaf_index(
                np.asarray(train_data.raw_data), -1)
        else:
            # a dataset without raw values (binary file) routes its bins
            leaf_preds = booster.predict_leaf_index_binned()
        booster.refit(leaf_preds)
        booster.save_model(cfg.output_model)
        self.booster = booster
        Log.info("Finished refit, saved model to %s", cfg.output_model)


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python -m lightgbm_tpu_torch config=<config file> "
              "[key=value ...]")
        return 1
    try:
        Application(argv, device=device).run()
    except resilience.TrainingPreempted as exc:
        Log.warning(str(exc))
        raise SystemExit(resilience.EXIT_PREEMPTED)
    except Exception as exc:  # main.cpp:23-41 catch-all
        Log.warning("Met Exceptions:")
        Log.warning(str(exc))
        raise SystemExit(1)
    return 0
