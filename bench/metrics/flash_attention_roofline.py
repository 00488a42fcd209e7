"""`csrc/flash_attention.cu`'s share of its roofline in the traced slice:
each prefill's calls (one a layer, causal over its prompt) at the larger
of 2*S^2*hd*H FLOPs at the bf16 peak and Q, K, V, O bytes at the HBM
peak (FLOPs bound them at these lengths), over the device time of the
flash kernels."""

from bench.readers import roofline


def read(run):
    return roofline(run, "flash")
