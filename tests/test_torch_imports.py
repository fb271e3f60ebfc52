"""The port stands alone and keeps its device rule.

Each check runs in a fresh interpreter (the host-API entry points and the
import with JAX blocked share one), so that what the test process itself
imported (JAX, the JAX package) cannot hide an import of the port:

- importing every module of ``lightgbm_tpu_torch`` leaves neither ``jax`` nor
  ``lightgbm_tpu`` in ``sys.modules``, every module imports with both
  blocked (the CLI, ingest, sklearn, plotting and codegen modules among
  them), and ``chip_smoke.py`` imports neither; ``http.server`` is imported
  only when a telemetry run serves a metrics port;
- with CUDA unavailable, an entry point called without ``device=`` raises
  instead of running on the CPU (the predictors of ``core/predict.py`` and
  ``core/predict_fused.py``, the CLI's ``Application`` and ``main``, ``cv``,
  the sklearn estimators, ``serve``, ``serve_and_train``, the serving
  ``Server`` and ``ModelRegistry``, ``plan.autotune.TuneDriver`` and an
  unpickled CUDA booster too), and
  ``device="cpu"`` is honoured, through training, ``pred_leaf``,
  ``pred_contrib`` and a checkpoint's round trip;
- ``chip_smoke.py`` exits nonzero and prints no result without CUDA.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run first in every child: CUDA is unavailable there, whatever the machine
NO_CUDA = "import torch; torch.cuda.is_available = lambda: False\n"


def run_python(code, cwd=REPO, args=()):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)]
                          + list(args), cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_port_imports_neither_jax_nor_the_jax_package():
    out = run_python("""
        import importlib, pkgutil, sys
        import lightgbm_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "lightgbm_tpu" or m.startswith("lightgbm_tpu."))
        wanted = {"engine", "basic", "callback", "core.histogram"}
        walked = wanted & {n.split(".", 1)[1] for n in names}
        print(len(names), len(walked) == len(wanted), bad)
    """)
    assert out.returncode == 0, out.stderr
    count, walked, bad = out.stdout.split(" ", 2)
    assert int(count) >= 20
    assert walked == "True"
    assert bad.strip() == "[]"


NEW_MODULES = ["cli", "__main__", "compat", "sklearn", "plotting",
               "model_codegen", "io.parser", "io.loader", "utils.timer",
               "engine", "basic", "c_api", "capi_build", "resilience",
               "utils.file_io", "parallel", "parallel.comm",
               "parallel.learners", "parallel.distdata",
               "obs", "obs.registry", "obs.trace", "obs.recompile",
               "obs.launches", "obs.hostmem", "obs.devmem", "obs.compile",
               "obs.spans", "obs.quality", "obs.exporter", "obs.report",
               "serving", "serving.registry", "serving.scheduler",
               "plan", "plan.autotune", "plan.cache", "plan.device_specs",
               "plan.planner", "plan.state", "obs.mfu", "obs.alerts",
               "obs.profiling", "core.compact", "online", "online.buffer",
               "online.policy", "online.controller"]


def test_every_module_imports_with_jax_blocked(host_api_child):
    walked = set(host_api_child["walked"])
    assert set(NEW_MODULES) <= walked, set(NEW_MODULES) - walked


def test_http_server_is_imported_only_by_the_exporter():
    """The exporter (``obs/exporter.py``) is imported lazily: importing the
    package, its telemetry and serving modules, training and serving with
    telemetry off import no ``http.server``; a run with a metrics port
    does."""
    out = run_python("""
        import socket, sys
        import numpy as np
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch import obs, serving
        from lightgbm_tpu_torch.obs import report, quality, devmem
        X = np.random.RandomState(0).normal(size=(300, 3))
        b = lgb.train({"objective": "binary", "verbosity": -1},
                      lgb.Dataset(X, (X[:, 0] > 0) * 1.0), 2, device="cpu")
        with b.serve() as srv:
            srv.predict("model", X[:8])
        before = "http.server" in sys.modules
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        obs.configure(metrics_port=port)
        obs.disable()
        print(before, "http.server" in sys.modules)
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].split() == ["False", "True"]


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "lightgbm_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "lightgbm_tpu"}


ENTRY_POINTS = {
    "resolve_device": """
        from lightgbm_tpu_torch.device import resolve_device
        resolve_device()
    """,
    "objective": """
        from lightgbm_tpu_torch import Config, create_objective
        create_objective("binary", Config(objective="binary"))
    """,
    "gbdt": """
        import numpy as np
        from lightgbm_tpu_torch import BinnedDataset, Config, GBDT
        X = np.random.RandomState(0).normal(size=(200, 3))
        ds = BinnedDataset.from_matrix(X, label=(X[:, 0] > 0) * 1.0)
        GBDT(Config(objective="binary"), ds)
    """,
    "learner": """
        import numpy as np
        from lightgbm_tpu_torch import BinnedDataset, Config
        from lightgbm_tpu_torch.core.tree_learner import SerialTreeLearner
        X = np.random.RandomState(0).normal(size=(200, 3))
        ds = BinnedDataset.from_matrix(X, label=(X[:, 0] > 0) * 1.0)
        SerialTreeLearner(ds, Config(objective="binary"))
    """,
    "load_model": """
        from lightgbm_tpu_torch.convert import gbdt_from_model_string
        gbdt_from_model_string("tree\\nversion=v3\\n")
    """,
    "train": """
        import numpy as np
        import lightgbm_tpu_torch as lgb
        X = np.random.RandomState(0).normal(size=(200, 3))
        lgb.train({"objective": "binary", "verbosity": -1},
                  lgb.Dataset(X, (X[:, 0] > 0) * 1.0), num_boost_round=1)
    """,
    "booster": """
        import numpy as np
        import lightgbm_tpu_torch as lgb
        X = np.random.RandomState(0).normal(size=(200, 3))
        lgb.Booster({"objective": "binary"},
                    lgb.Dataset(X, (X[:, 0] > 0) * 1.0))
    """,
    "booster_from_model_string": """
        from lightgbm_tpu_torch.convert import booster_from_model_string
        booster_from_model_string("tree\\nversion=v3\\n")
    """,
    "fused_predictor": """
        from lightgbm_tpu_torch.core.predict_fused import FusedPredictor
        from lightgbm_tpu_torch.core.tree import Tree
        FusedPredictor([Tree(1)])
    """,
    "stacked_trees": """
        from lightgbm_tpu_torch.core.predict import StackedTrees
        StackedTrees([])
    """,
    "build_histogram": """
        import numpy as np
        from lightgbm_tpu_torch.core.histogram import build_histogram
        build_histogram(np.zeros((8, 2), np.uint8),
                        np.zeros((2, 8), np.float32), 32)
    """,
}


# the CLI and host-API entry points: driven in one child (below)
HOST_API_ENTRY_POINTS = {
    "application": """
        from lightgbm_tpu_torch.cli import Application
        Application(["task=train", "data=missing.train"])
    """,
    "gbdt_load_model": """
        from lightgbm_tpu_torch import GBDT
        import tempfile, os
        path = os.path.join(tempfile.mkdtemp(), "m.txt")
        open(path, "w").write("tree\\nversion=v3\\n")
        GBDT.load_model(path)
    """,
    "cv": """
        import numpy as np
        import lightgbm_tpu_torch as lgb
        X = np.random.RandomState(0).normal(size=(200, 3))
        lgb.cv({"objective": "binary", "verbosity": -1},
               lgb.Dataset(X, (X[:, 0] > 0) * 1.0), num_boost_round=1,
               nfold=2)
    """,
    "sklearn": """
        import numpy as np
        import lightgbm_tpu_torch as lgb
        X = np.random.RandomState(0).normal(size=(200, 3))
        lgb.LGBMClassifier(n_estimators=1).fit(X, X[:, 0] > 0)
    """,
    "c_api_booster_create": """
        import ctypes
        from lightgbm_tpu_torch import c_api
        out = ctypes.c_void_p()
        if c_api.bind()["LGBM_BoosterCreate"](0, 0, ctypes.addressof(out)):
            raise RuntimeError(c_api.get_last_error())
    """,
    "serve": """
        import lightgbm_tpu_torch as lgb
        lgb.serve({})
    """,
    "serving_server": """
        from lightgbm_tpu_torch.serving import Server
        Server()
    """,
    "model_registry": """
        from lightgbm_tpu_torch.serving import ModelRegistry
        ModelRegistry()
    """,
    "serve_and_train": """
        import lightgbm_tpu_torch as lgb
        lgb.serve_and_train("model.txt")
    """,
    "autotune": """
        from lightgbm_tpu_torch.plan import autotune, planner
        autotune.TuneDriver(planner.shape_class(1000, 4, 32,
                                                device_kind="cpu"))
    """,
    "unpickle_cuda_booster": """
        import lightgbm_tpu_torch as lgb
        lgb.Booster.__new__(lgb.Booster).__setstate__(
            {"params": {}, "model_str": "tree\\nversion=v3\\n",
             "best_iteration": -1, "best_score": {}, "device": "cuda"})
    """,
}

# One child for the host-API entry points and the import of every module
# with JAX and the JAX package blocked (each entry point in a namespace of
# its own): one interpreter's start-up, torch's import and sklearn's instead
# of one for each.
HOST_API_CHILD = NO_CUDA + """
import importlib, json, pkgutil, sys, textwrap, traceback
for blocked in ("jax", "jaxlib", "lightgbm_tpu"):
    sys.modules[blocked] = None
import lightgbm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
raised = {}
for entry, code in json.loads(sys.argv[1]).items():
    try:
        exec(textwrap.dedent(code), {})
        raised[entry] = ""
    except Exception:
        raised[entry] = traceback.format_exc()
print(json.dumps({"walked": [n.split(".", 1)[1] for n in names],
                  "raised": raised}))
"""


@pytest.fixture(scope="module")
def host_api_child():
    out = run_python(HOST_API_CHILD,
                     args=[json.dumps(HOST_API_ENTRY_POINTS)])
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("entry", list(ENTRY_POINTS)
                         + list(HOST_API_ENTRY_POINTS))
def test_entry_point_without_device_raises_without_cuda(entry, request):
    if entry in ENTRY_POINTS:
        out = run_python(NO_CUDA + textwrap.dedent(ENTRY_POINTS[entry]))
        assert out.returncode != 0
        err = out.stderr
    else:
        err = request.getfixturevalue("host_api_child")["raised"][entry]
    assert "CUDA is not available" in err, err


def test_cli_main_without_device_fails_without_cuda(tmp_path):
    """``cli.main`` (and so ``python -m lightgbm_tpu_torch``) runs on CUDA:
    without it, it exits 1 naming the reason, and writes no model."""
    model = str(tmp_path / "m.txt")
    out = run_python(NO_CUDA + textwrap.dedent("""
        import sys
        from lightgbm_tpu_torch.cli import main
        sys.exit(main(["task=train", "data=x.train",
                       "output_model=%s"]))
    """ % model))
    assert out.returncode == 1
    assert "CUDA is not available" in out.stdout + out.stderr
    assert not os.path.exists(model)


def test_entry_point_runs_on_cpu_when_asked():
    out = run_python(NO_CUDA + textwrap.dedent("""
        import numpy as np
        from lightgbm_tpu_torch import BinnedDataset, Config, GBDT
        from lightgbm_tpu_torch import create_objective
        X = np.random.RandomState(0).normal(size=(300, 3))
        ds = BinnedDataset.from_matrix(X, label=(X[:, 0] > 0) * 1.0)
        cfg = Config(objective="binary", num_leaves=4, verbosity=-1)
        b = GBDT(cfg, ds, create_objective("binary", cfg, device="cpu"),
                 device="cpu")
        b.train_one_iter()
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch.core.histogram import build_histogram
        bst = lgb.train({"objective": "binary", "num_leaves": 4,
                         "verbosity": -1},
                        lgb.Dataset(X, (X[:, 0] > 0) * 1.0),
                        num_boost_round=2, verbose_eval=False, device="cpu")
        h = build_histogram(np.zeros((8, 2), np.uint8),
                            np.ones((2, 8), np.float32), 32, device="cpu")
        leaves = bst.predict(X, pred_leaf=True)
        phi = bst.predict(X[:20], pred_contrib=True)
        import tempfile, os
        prefix = os.path.join(tempfile.mkdtemp(), "m")
        bst.save_checkpoint(prefix)
        again = lgb.Booster({"objective": "binary", "num_leaves": 4,
                             "verbosity": -1},
                            lgb.Dataset(X, (X[:, 0] > 0) * 1.0),
                            device="cpu")
        print(b.train_score.device, len(b.models), bst.device,
              bst.num_trees(), float(h[0, 0, 0]), leaves.shape[1],
              phi.shape[1], again.resume_from_checkpoint(prefix))
    """))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].split() == ["cpu", "1", "cpu", "2",
                                                   "8.0", "2", "4", "2"]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        with open(script) as fh:
            (tmp_path / "chip_smoke.py").write_text(fh.read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        cwd = REPO
    out = run_python(NO_CUDA + "import runpy, sys\n"
                     "sys.argv = [%r]\n" % script
                     + "runpy.run_path(%r, run_name='__main__')\n" % script,
                     cwd=cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_c_shim_imports_only_the_port():
    """The generated C library imports one module, the port's C ABI (and
    so, through it, nothing of JAX: the walk above covers ``c_api``)."""
    import re
    sys.path.insert(0, REPO)
    try:
        from lightgbm_tpu_torch import capi_build
    finally:
        sys.path.pop(0)
    src = capi_build.c_source()
    assert set(re.findall(r'PyImport_ImportModule\("([\w.]+)"\)', src)) \
        == {"lightgbm_tpu_torch.c_api"}
    assert "jax" not in src and "lightgbm_tpu." not in src
