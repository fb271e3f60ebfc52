"""Device kernels the traced window ran, over its iterations: the host's
issuing, one launch at a time."""


def read(ctx):
    run = ctx["run"]
    if run.trace is None or not run.iterations:
        return None
    kernels = run.trace.kernels
    return len(kernels) / run.iterations if kernels else None
