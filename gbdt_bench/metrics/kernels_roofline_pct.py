"""The port's own kernels (histograms, split and level passes) against the
least time their work needs (``harness/cost.py``): that least time over
their summed device time, in percent."""
from harness import cost
from harness.profile import is_port_kernel


def read(ctx):
    run = ctx["run"]
    if run.trace is None or not run.window_trees:
        return None
    ns = sum(d for name, _, d in run.trace.kernels if is_port_kernel(name))
    if not ns:
        return None
    least = cost.least_work(run.window_trees, run.n_rows, ctx["num_bins"],
                            ctx["precision"])
    return 100.0 * least["seconds"] / (ns * 1e-9)
