"""Seconds from the process's start to the end of set-up: imports, the
kernels' build (the first run in a checkout), weights, inputs, warm-up."""


def read(run):
    return run.setup_s
