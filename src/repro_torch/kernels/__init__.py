"""The port's kernels: CUDA C++ for Hopper (`csrc/`), their wrappers
(`ops`) and their plain PyTorch versions (`ref`)."""
