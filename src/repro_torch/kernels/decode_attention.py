"""Decode attention on the card: `csrc/decode_attention.cu`.

Replaces `repro/kernels/decode_attention.py::decode_attention_grouped`.
One decode step of GQA attention, q (B,H,hd) over a KV cache
(B,W,KVH,hd), with a valid length per row. The plain version is
`ref.decode_attention`; `ops.decode_attention` picks between them by the
tensors' device.

The kernel splits the W cache slots over `split_count(B, KVH, W)` blocks
per (row, KV head) and merges their partial softmax states in a second
launch; both launches are one call here and one count in `KERNEL`. The
partial states go to a workspace kept per (device, stream), so that a
call allocates only its output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import CudaKernel, check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("decode_attention", "decode_attention",
                    [_P] * 7 + [_I] * 7 + [_P])
MAX_GROUP = 16     # query heads per KV head
MAX_HEAD_DIM = 256
SM_COUNT = 132     # NVIDIA H100 SXM
BLOCKS_PER_SM = 2  # the split rule's target: this many blocks for every SM
MAX_CHUNK = 128    # slots a block walks at most: four of its 32-row tiles


def split_count(b: int, kvh: int, w: int, sms: int = SM_COUNT) -> int:
    """Chunks the W cache slots split into: the fewest that give
    `b * kvh * splits >= BLOCKS_PER_SM * sms` blocks and chunks of at most
    MAX_CHUNK slots, and at most `w` (a slot per split). A block walks its
    chunk's tiles one after another, so the longest chunk sets the time.
    From shapes alone: the lengths live on the card, and reading them would
    cost a host sync."""
    want = max(-(-BLOCKS_PER_SM * sms // (b * kvh)), -(-w // MAX_CHUNK))
    return max(1, min(w, want))


@functools.lru_cache(maxsize=None)
def splits_for(b: int, kvh: int, w: int, device: int) -> int:
    """`split_count` on the SM count of CUDA device number `device`, once
    per shape: the decode step calls the kernel 40 times a step at one
    shape."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return split_count(b, kvh, w, sms)


_WORKSPACES: dict = {}   # (device index, stream) -> f32 workspace


def workspace(n: int, device: torch.device, stream: int) -> torch.Tensor:
    """An f32 workspace of at least `n` elements for the calls on `stream`.
    Calls on one stream run in order, so they share it; it lives as long as
    the process and is replaced by a larger one when a call needs more.
    So a call allocates only its output: the decode step is host-bound,
    and a fresh ~1 MB workspace per call (the path's shape) costs host
    time (PERF.md)."""
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < n:
        ws = _WORKSPACES[key] = torch.empty(n, dtype=torch.float32,
                                            device=device)
    return ws


def workspaces(stream: int) -> list[torch.Tensor]:
    """The workspaces kept for the calls on `stream`: a CUDA graph
    captured there holds their addresses, so its owner keeps them alive
    (a larger workspace may replace one in the table)."""
    return [ws for (_, s), ws in _WORKSPACES.items() if s == stream]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, return_lse: bool = False):
    """Launch the kernel. q: (B,H,hd); k, v: (B,W,KVH,hd), 16-byte aligned;
    lengths: int32 (B,) with 1 <= lengths[b] <= W (a documented
    precondition, not checked: that would cost a host sync). All on one
    CUDA device, contiguous; f32 or bf16. Returns (B,H,hd) in q's dtype,
    and with `return_lse` also each row's f32 log-sum-exp of its scaled
    scores, (B,H), natural log (the output's bits do not change)."""
    tensors = (q, k, v, lengths)
    check_cuda("decode_attention", *tensors)
    b, h, hd = q.shape
    w, kvh = k.shape[1], k.shape[2]
    if h // kvh > MAX_GROUP or hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"decode_attention kernel takes at most {MAX_GROUP} "
                         f"query heads per KV head and a head_dim that is a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}; got "
                         f"{h // kvh} and {hd}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"lengths must be int32 ({b},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k and v must start on a 16-byte "
                         "boundary (the kernel copies 16-byte pieces)")
    splits = splits_for(b, kvh, w, q.get_device())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = workspace(b * h * splits * (hd + 2), q.device, stream)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), ws.data_ptr(),
                  b, kvh, h // kvh, w, hd, splits,
                  int(q.dtype == torch.bfloat16), stream)
    return (out, lse) if return_lse else out
