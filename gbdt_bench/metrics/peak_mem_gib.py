"""The device allocator's peak over set-up and window, in GiB, counted
from after the benchmark's own data generation freed its tensors."""


def read(ctx):
    peak = ctx["run"].peak_bytes
    return peak / float(1 << 30) if peak else None
