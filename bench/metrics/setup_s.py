"""Seconds from process start to the window's start: imports, kernel
builds or loads, weights, the engine and its cache, warm-up and, in a
closed loop, the clients' requests in progress."""


def read(run):
    return run.setup_s
