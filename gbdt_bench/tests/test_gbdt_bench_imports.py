"""What the benchmark may load: nothing of JAX or of the JAX package in a
run, and nothing of the program in the reference."""
import ast
import json
import subprocess
import sys

import pytest

from conftest import BENCH
from harness import chip

TOP = {"jax", "jaxlib", "flax", "lightgbm_tpu", "lightgbm_tpu_torch"}


def _imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    tops = set(_imported_tops(path))
    assert not tops & set(chip.FORBIDDEN)
    if path.parent.name == "reference":
        assert "lightgbm_tpu_torch" not in tops


def _modules_after(code):
    script = ("import sys; sys.path[:0] = [%r, %r]\n%s\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))" % (str(BENCH), str(BENCH.parent),
                                            code))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _modules_after("import reference.gbdt, reference.judge, "
                          "reference.model_text")
    assert not tops & TOP


def test_a_run_loads_no_jax():
    code = """
import time, torch
torch.set_num_threads(2)
from harness import cells
from conftest import small_config
import run
cell = cells.cell("higgs-leaf")
res, checks, r = run.execute(cell, 5, 1.0, False, "cpu", time.perf_counter(),
                             config=small_config(cell, rows=4000))
assert res["correct"], checks
from harness import chip
assert chip.forbidden_modules() == [], chip.forbidden_modules()
"""
    tops = _modules_after("sys.path.insert(0, %r)\n%s"
                          % (str(BENCH / "tests"), code))
    assert "lightgbm_tpu_torch" in tops
    assert not tops & set(chip.FORBIDDEN)


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lightgbm_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert chip.forbidden_modules() == ["jaxlib"]
