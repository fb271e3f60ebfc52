"""Milliseconds of device time an iteration in kernels that are not the
port's own (the split scan, the bookkeeping, the objective: PyTorch's)."""
from harness.profile import is_port_kernel


def read(ctx):
    run = ctx["run"]
    if run.trace is None or not run.iterations:
        return None
    ns = sum(d for name, _, d in run.trace.kernels if not is_port_kernel(name))
    return ns * 1e-6 / run.iterations if ns else None
