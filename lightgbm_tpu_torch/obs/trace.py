"""Named trace ranges for device profiles.

The counterpart of ``lightgbm_tpu/obs/trace.py`` (:1-28), where
``jax.profiler.TraceAnnotation`` names a host span in the trace viewer.
Here a name becomes a ``torch.profiler.record_function`` range, so a
``torch.profiler`` trace (``chip_smoke.py --profile``) reads
``fused_train_chunk``, ``tree_block_predict`` or ``serve_dispatch`` over
the kernels the span launched, and, when CUDA is up, also an NVTX range
(``torch.cuda.nvtx.range``) for an external profiler.  With no profiler
attached a range costs a few microseconds; every fixed use is at dispatch
granularity (a predict call, a served batch), never per row.  The spans of
``obs/spans.py`` (``tree_build``, ``split_scan``, ...) open one each while
a span collector is open, and only then.
"""
from __future__ import annotations

import torch

# the profiler's range: torch's light form where it has one (a RecordFunction
# without the Python wrapper's dispatcher call, ~1 us against ~15 us on a
# CPU host), else ``record_function``; both record only under a profiler
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function


class annotate:
    """Context manager naming the enclosed span in device/host profiles."""

    __slots__ = ("name", "_range", "_nvtx")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "annotate":
        self._range = _RANGE(self.name)
        self._range.__enter__()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._range.__exit__(*exc)
        return False
