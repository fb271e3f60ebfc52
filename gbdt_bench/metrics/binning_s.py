"""Seconds of the program's binning: the benchmark's own span around
``Dataset.construct()``."""


def read(ctx):
    return ctx["run"].binning_s
