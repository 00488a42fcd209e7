"""`csrc/decode_attention.cu`'s share of its roofline in the traced
slice: each decode step's calls (one a layer) at the bytes of the K/V
rows up to each live slot's length, its query and output, at the HBM
peak (bytes bound it), over the device time of the split and merge
kernels."""

from bench.readers import roofline


def read(run):
    return roofline(run, "decode")
