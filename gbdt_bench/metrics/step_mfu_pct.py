"""The whole step's share of the card's peak: the least time the window's
trees need (``harness/cost.py``) over the traced window's wall time, in
percent."""
from harness import cost


def read(ctx):
    run = ctx["run"]
    if (run.trace is None or not run.trace.device or not run.window_trees
            or run.window_s <= 0):
        return None
    least = cost.least_work(run.window_trees, run.n_rows, ctx["num_bins"],
                            ctx["precision"])
    return 100.0 * least["seconds"] / run.window_s
