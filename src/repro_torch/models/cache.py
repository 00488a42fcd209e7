"""Decode caches: full and sliding-window-ring KV, cross-attention KV, and
the recurrent states of mamba and RWKV layers.

Counterpart of `repro.models.cache`. Slot -> position math derives from
one count of tokens written, so no positions array is stored:

  full cache (W == max_len):  slot s holds position s, valid iff s < count
  ring cache (W == window):   slot s holds p = (count-1) - ((count-1 - s) % W),
                              valid iff p >= 0

Unlike the functional reference, `write_decode` and `write_prefill` update
the cache tensors IN PLACE (and return the same dict), so a decode step
never copies the cache.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .config import ModelConfig, torch_dtype
from .mamba import mamba_state_defs
from .rwkv import rwkv_state_defs
from .sharding import ParamDef, stack_defs, tree_map


def kv_defs(cfg: ModelConfig, batch: int, width: int, name: str) -> dict:
    kvh, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": ParamDef((batch, width, kvh, hd),
                      ("batch", "cache_seq", None, None), f"{name}.k", "zeros"),
        "v": ParamDef((batch, width, kvh, hd),
                      ("batch", "cache_seq", None, None), f"{name}.v", "zeros"),
    }


def cross_kv_defs(cfg: ModelConfig, batch: int, name: str) -> dict:
    kvh, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": ParamDef((batch, cfg.encoder_seq, kvh, hd),
                      ("batch", "cache_seq", None, None), f"{name}.ck", "zeros"),
        "v": ParamDef((batch, cfg.encoder_seq, kvh, hd),
                      ("batch", "cache_seq", None, None), f"{name}.cv", "zeros"),
    }


def cache_width(cfg: ModelConfig, max_len: int) -> int:
    """Ring-buffer width: the window if it is smaller than the context."""
    if cfg.sliding_window and cfg.sliding_window < max_len:
        return cfg.sliding_window
    return max_len


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """ParamDef tree for the whole decode cache (stacked over blocks): KV
    for attention layers (plus the cross-attention KV under `cross` where
    the layer has it), `h` and `conv` for mamba, `wkv`, `shift_tm` and
    `shift_cm` for RWKV."""
    width = cache_width(cfg, max_len)
    per_pos = []
    for i, spec in enumerate(cfg.layer_pattern()):
        name = f"cache.l{i}"
        if spec.kind == "attn":
            d = kv_defs(cfg, batch, width, name)
            if spec.cross_attn:
                d.update(cross=cross_kv_defs(cfg, batch, name))
        elif spec.kind == "mamba":
            d = mamba_state_defs(cfg, batch, name)
        elif spec.kind == "rwkv":
            d = rwkv_state_defs(cfg, batch, name)
        else:
            d = {}
        per_pos.append(d)
    return {
        "index": ParamDef((), (), "cache.index", "zeros", "int32"),
        "layers": [stack_defs(d, cfg.n_blocks) for d in per_pos],
    }


def state_dtype(cfg: ModelConfig) -> torch.dtype:
    """The type of the recurrent states (RWKV's `wkv`, mamba's `h`): f32,
    as the reference keeps them, or f64 in an f64 model."""
    return torch.promote_types(torch_dtype(cfg.dtype), torch.float32)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zero-initialized cache on `device` (None: the card). The reference's
    dtype rule: the recurrent states in `state_dtype`, every other leaf in
    the model's dtype."""
    dev = resolve_device(device)

    def mk(d: ParamDef):
        if d.dtype:
            dt = torch_dtype(d.dtype)
        elif "wkv" in d.name or d.name.endswith(".h"):
            dt = state_dtype(cfg)
        else:
            dt = torch_dtype(cfg.dtype)
        return torch.zeros(d.shape, dtype=dt, device=dev)
    return tree_map(mk, cache_defs(cfg, batch, max_len))


def slot_positions(count, width: int):
    """True position held by each slot given `count` tokens written.

    count: scalar -> (W,); per-row (B,) -> (B, W). -1 marks empty slots."""
    count = torch.as_tensor(count, dtype=torch.int32)
    s = torch.arange(width, dtype=torch.int32, device=count.device)
    idx1 = count - 1
    if idx1.dim():
        idx1 = idx1[:, None]
    pos = idx1 - torch.remainder(idx1 - s, width)
    return torch.where(pos >= 0, pos, -1)


def write_decode(kv: dict, k_new, v_new, index, width: int) -> dict:
    """Insert one token's k/v at slot index % width, in place.
    k_new: (B,1,KVH,hd). index: scalar (synchronized batch) or (B,)
    per-row positions."""
    slot = torch.remainder(
        torch.as_tensor(index, device=kv["k"].device).long(), width)
    if slot.dim() == 0:     # index_copy_ reads the slot on the device: no sync
        kv["k"].index_copy_(1, slot.reshape(1), k_new.to(kv["k"].dtype))
        kv["v"].index_copy_(1, slot.reshape(1), v_new.to(kv["v"].dtype))
    else:
        rows = torch.arange(slot.shape[0], device=slot.device)
        kv["k"][rows, slot] = k_new[:, 0].to(kv["k"].dtype)
        kv["v"][rows, slot] = v_new[:, 0].to(kv["v"].dtype)
    return kv


def write_prefill(kv: dict, k_full, v_full) -> dict:
    """Write a prefill's k/v into slots [0, s), in place. If the prefill
    is longer than the (ring) cache, keep the last `width` tokens at their
    p % width slots."""
    s, width = k_full.shape[1], kv["k"].shape[1]
    if s > width:
        k_full = torch.roll(k_full[:, s - width:], s % width, dims=1)
        v_full = torch.roll(v_full[:, s - width:], s % width, dims=1)
        s = width
    kv["k"][:, :s] = k_full.to(kv["k"].dtype)
    kv["v"][:, :s] = v_full.to(kv["v"].dtype)
    return kv
