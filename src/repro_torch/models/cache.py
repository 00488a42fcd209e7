"""Decode caches: full and sliding-window-ring KV, cross-attention KV, and
the recurrent states of mamba and RWKV layers.

Counterpart of `repro.models.cache`. Slot -> position math derives from
one count of tokens written, so no positions array is stored:

  full cache (W == max_len):  slot s holds position s, valid iff s < count
  ring cache (W == window):   slot s holds p = (count-1) - ((count-1 - s) % W),
                              valid iff p >= 0

Unlike the functional reference, `write_decode` and `write_prefill` update
the cache tensors IN PLACE (and return the same dict), so a decode step
never copies the cache. On a mesh (DTensor caches) each device writes
its own rows and, where the sequence is sharded (flash-decoding), only
the slots of its own sequence shard, through `local_map`: DTensor
refuses in-place updates that would change a placement, and each write
is local by construction.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..dist import local_extent
from .config import ModelConfig, torch_dtype
from .mamba import mamba_state_defs
from .rwkv import rwkv_state_defs
from .sharding import ParamDef, is_dtensor, stack_defs, tree_map


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


def leaf_dtype(cfg: ModelConfig, d: ParamDef) -> torch.dtype:
    """The reference's dtype rule for a cache leaf: the recurrent states
    in `state_dtype`, every other leaf in the model's dtype (unless the
    def names one)."""
    if d.dtype:
        return torch_dtype(d.dtype)
    if "wkv" in d.name or d.name.endswith(".h"):
        return state_dtype(cfg)
    return torch_dtype(cfg.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, shd=None) -> dict:
    """Zero-initialized cache on `device` (None: the card), each leaf in
    `leaf_dtype`. With `shd` on a mesh each leaf is a DTensor of its
    spec."""
    dev = resolve_device(device)

    def mk(d: ParamDef):
        t = torch.zeros(d.shape, dtype=leaf_dtype(cfg, d), device=dev)
        if shd is not None and shd.mesh is not None:
            t = shd.place(t, shd.spec(d.shape, d.kinds, d.name))
        return t
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
    if is_dtensor(kv["k"]):
        return _write_sharded(kv, k_new, v_new, index, width)
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
    if is_dtensor(kv["k"]):
        return _write_sharded(kv, k_full, v_full, None, kv["k"].shape[1])
    k_full, v_full = _last_window(k_full, v_full, kv["k"].shape[1])
    s = k_full.shape[1]
    kv["k"][:, :s] = k_full.to(kv["k"].dtype)
    kv["v"][:, :s] = v_full.to(kv["v"].dtype)
    return kv


def _last_window(k_full, v_full, width: int):
    """A prefill's k/v as a cache of `width` slots holds them: all of
    them, or past the width the last `width` tokens rolled to their
    p % width slots."""
    s = k_full.shape[1]
    if s > width:
        k_full = torch.roll(k_full[:, s - width:], s % width, dims=1)
        v_full = torch.roll(v_full[:, s - width:], s % width, dims=1)
    return k_full, v_full


def _write_sharded(kv: dict, k_new, v_new, index, width: int) -> dict:
    """`write_prefill` (index None: slots [0, s), past the width its last
    window) or `write_decode` (one token per row at index % width) into
    DTensor caches: each device writes its rows' slots that fall in its
    own sequence shard, through `local_map` on the cache's own placements
    (the new rows come replicated over the sequence shards)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    cache = kv["k"]
    mesh, plc = cache.device_mesh, tuple(cache.placements)
    new_plc = tuple(Replicate() if p == Shard(1) else p for p in plc)
    shape, offset = local_extent(
        cache.shape, mesh, plc)
    lo, n_loc = offset[1], shape[1]
    if index is not None:
        slot = torch.remainder(torch.as_tensor(index, device=cache.device)
                               .long(), width).reshape(-1)
        slot = slot.expand(cache.shape[0]).contiguous()
        if not is_dtensor(slot):
            from torch.distributed.tensor import DTensor
            slot = DTensor.from_local(slot, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        slot_plc = tuple(p if p == Shard(0) else Replicate() for p in plc)
    else:
        slot, slot_plc = None, None

    def write(k_loc, v_loc, k_src, v_src, slot_loc):
        if slot_loc is None:
            k_src, v_src = _last_window(k_src, v_src, width)
        for dst, src in ((k_loc, k_src), (v_loc, v_src)):
            src = src.to(dst.dtype)
            if slot_loc is None:                      # prefill
                n = max(min(src.shape[1] - lo, n_loc), 0)
                if n:
                    dst[:, :n] = src[:, lo:lo + n]
                continue
            rows = torch.arange(dst.shape[0], device=dst.device)
            mine = (slot_loc >= lo) & (slot_loc < lo + n_loc)
            at = torch.clamp(slot_loc - lo, 0, n_loc - 1)
            dst[rows, at] = torch.where(mine[:, None, None], src[:, 0],
                                        dst[rows, at])
        return k_loc

    args = (kv["k"], kv["v"], k_new, v_new)
    in_plc = (plc, plc, new_plc, new_plc)
    if slot is not None:
        args, in_plc = args + (slot,), in_plc + (slot_plc,)
    else:
        args, in_plc = args + (None,), in_plc + (None,)
    local_map(write, out_placements=list(plc), in_placements=in_plc,
              redistribute_inputs=True, device_mesh=mesh)(*args)
    return kv
