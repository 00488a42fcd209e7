"""The whole model's share of the device's bf16 peak over the window: the
FLOPs that the window's prefills and decode steps need (the benchmark's
count), over its seconds."""

from bench.readers import mfu


def read(run):
    return mfu(run)
