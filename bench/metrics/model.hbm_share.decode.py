"""The whole model's share of the device's HBM bandwidth over the window:
the bytes that the window's decode steps and prefills need (weights read
once a call, K/V rows up to each live slot's length; the benchmark's
count), over its seconds."""

from bench.readers import hbm_share


def read(run):
    return hbm_share(run)
