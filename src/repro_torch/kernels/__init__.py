"""The port's kernels: CUDA C++ for Hopper (`csrc/`), their wrappers
(`ops`) and their plain PyTorch versions (`ref`)."""

import contextlib


@contextlib.contextmanager
def graph_capture(stream):
    """Around a CUDA graph's capture on `stream` (a `torch.cuda.Stream`),
    which runs none of the launches it records: yields the
    `_build.HeldLaunches` that the kernels' counters count into meanwhile,
    for the graph's owner to `credit` once per replay. On exit its `keep`
    holds the kernels' own buffers that the graph reads at fixed
    addresses (the decode kernel's workspace for `stream`), which the
    owner keeps alive as long as the graph."""
    from . import _build, decode_attention
    with _build.hold_launches() as held:
        yield held
    held.keep = decode_attention.workspaces(stream.cuda_stream)
