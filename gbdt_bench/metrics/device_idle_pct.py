"""The traced window's wall time in which no device activity ran, in
percent of it."""


def read(ctx):
    run = ctx["run"]
    if run.trace is None or not run.trace.device or run.window_s <= 0:
        return None
    return 100.0 * (run.window_s - run.trace.busy_s()) / run.window_s
