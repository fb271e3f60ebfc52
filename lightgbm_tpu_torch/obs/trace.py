"""Named trace ranges for device profiles.

The counterpart of ``lightgbm_tpu/obs/trace.py`` (:1-28), where
``jax.profiler.TraceAnnotation`` names a host span in the trace viewer.
Here a name becomes a ``torch.profiler.record_function`` range, so a
``torch.profiler`` trace (``chip_smoke.py --profile``) reads
``tree_build``, ``tree_block_predict`` or ``serve_dispatch`` over the kernels
the span launched, and, when CUDA is up, also an NVTX range
(``torch.cuda.nvtx.range``) for an external profiler.  With no profiler
attached a range costs a few microseconds; every use is at dispatch
granularity (a tree, a predict call, a served batch), never per row.
"""
from __future__ import annotations

from contextlib import ExitStack

import torch


def annotate(name: str):
    """Context manager naming the enclosed span in device/host profiles."""
    stack = ExitStack()
    stack.enter_context(torch.profiler.record_function(name))
    if torch.cuda.is_available():
        stack.enter_context(torch.cuda.nvtx.range(name))
    return stack
