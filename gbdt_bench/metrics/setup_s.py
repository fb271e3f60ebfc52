"""Seconds from process start to the first timed iteration."""


def read(ctx):
    return ctx["run"].setup_s
