"""Seconds a boosting iteration: the window's wall time over its whole
iterations (one quotient, never a median of iterations)."""


def read(ctx):
    run = ctx["run"]
    return run.window_s / run.iterations if run.iterations else None
