"""The port's level growth against the JAX package's own level path, with
quantized gradients (``hist_precision=quantized``).

The same check as ``test_torch_level_oracle.py`` (the interpret-mode shim set
with ``monkeypatch``, 4096 rows x 8 features, max_bin=63, num_leaves=15, 2
iterations), in a file of its own so that xdist runs the two ~40 s oracles
on different workers.  Histograms are integer sums on both sides, so the
trees must be equal and the leaf values within the same tolerance.
"""
import torch

from test_torch_level_oracle import (_shim_is_undone,  # noqa: F401
                                     check_against_reference, run_both)
from test_torch_quant import one_thread  # noqa: F401

torch.set_num_threads(2)


def test_level_growth_matches_jax_level_path_quantized(monkeypatch,
                                                       one_thread):
    check_against_reference(*run_both(monkeypatch, "quantized"))
