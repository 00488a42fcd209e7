"""repro_torch — the PyTorch/CUDA port of `repro` for one NVIDIA H100.

The JAX package `repro` stays the reference; this package imports nothing
of it (nor JAX). Layout mirrors `repro`: `configs`, `models` (config,
sharding, layers, cache, transformer), `serve.engine`, `launch.serve`,
and `kernels` (CUDA C++ under `kernels/csrc`, wrappers in `kernels.ops`,
plain PyTorch versions in `kernels.ref`). Entry points take `device=None`,
meaning the card; tests pass `device="cpu"`. `bridge` moves a reference
parameter tree, as numpy arrays, into the port.
"""
