"""A configuration file as the program under test takes it: the
`repro_torch.models.ModelConfig` of its published keys.

Values the program has no option for (the multipliers granite's config
states, a shared-expert gate other than the port's) must stand at what
the program does; the file records the published value under
`departures`.
"""

from __future__ import annotations

import math

from .weights import dims

_NEUTRAL = ("embedding_multiplier", "residual_multiplier", "logits_scaling")


def model_config(c: dict):
    """`ModelConfig` for configuration file `c`; raises where the file
    asks for what the program cannot run."""
    from repro_torch.models import ModelConfig
    s = dims(c)
    for key in _NEUTRAL:
        if float(c.get(key, 1.0)) != 1.0:
            raise ValueError(f"{c['name']}: the program has no {key}")
    scale = c.get("attention_multiplier")
    if scale is not None and not math.isclose(scale, 1 / math.sqrt(s["hd"]),
                                              rel_tol=1e-12):
        raise ValueError(f"{c['name']}: the program scales scores by "
                         "1/sqrt(head_dim) only")
    if c.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{c['name']}: hidden_act {c['hidden_act']!r}")
    gate = c.get("shared_expert_gate")
    if s["Fs"] and (gate == "sigmoid") != c["name"].startswith("qwen2-moe"):
        # the port gates a shared expert by a sigmoid for qwen2-moe alone
        raise ValueError(f"{c['name']}: shared expert gate {gate!r}")
    if s["E"] and not c.get("norm_topk_prob", False):
        raise ValueError(f"{c['name']}: the program normalises the top-k "
                         "gate weights")
    if s["E"]:
        from repro_torch.models import layers
        if layers.CAPACITY_FACTOR != c.get("moe_capacity_factor"):
            raise ValueError(f"{c['name']}: the program's capacity factor "
                             f"is {layers.CAPACITY_FACTOR}")
    if c.get("use_sliding_window") or c.get("sliding_window_active"):
        raise ValueError(f"{c['name']}: sliding windows are not laid out "
                         "by this benchmark")
    return ModelConfig(
        name=c["name"], family="moe" if s["E"] else "dense",
        n_layers=s["L"], d_model=s["D"], n_heads=s["H"],
        n_kv_heads=s["KVH"], d_ff=s["F"], vocab_size=s["V"],
        head_dim=s["hd"], rope_theta=float(c["rope_theta"]),
        attn_bias=s["bias"], n_experts=s["E"], top_k=s["k"],
        moe_d_ff=s["Fe"], n_shared_experts=1 if s["Fs"] else 0,
        shared_d_ff=s["Fs"], norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=s["tie"], dtype=c["torch_dtype"])
