"""The decoder family: a decoder LM whose every layer is alike, GQA
attention and a dense or routed-MoE MLP (with or without a shared
expert), block-stacked in one dict of the program's `params["layers"]`.
A configuration file whose `reference` is `decoder` is of this family.

`model_config`: values the program has no option for (the multipliers
granite's config states, a shared-expert gate other than the port's)
must stand at what the program does; the file records the published
value under `departures`.

`layout`: a weight's std is 1/sqrt(its contraction width); the query and
key projections are sqrt(QK_SPREAD) times that, so that scores spread by
about QK_SPREAD and attention is neither uniform nor one-hot; norm
scales are 1 + 0.1 normal, biases 0.1 normal (so that a dropped scale or
bias shows in the comparison); the vocabulary is padded to a multiple of
`VOCAB_PAD` rows, as the program's embedding is.

`Counts`: what is counted is what the inputs need, not what the program
happens to do: the unembedding once per emitted token (not over every
prompt position); a decode call's K/V rows up to each live slot's own
length (a slot that holds no request needs none); in the MoE layer the
top-k experts of each token for FLOPs and, for bytes, the experts a
step's tokens route to (the expected number of distinct experts under
uniform routing: the benchmark does not see the router). A product of
m x n by n x p is 2mnp FLOPs. Norms, RoPE, softmax and other elementwise
work, and activations' bytes, are left out: they are a small share at
these widths, and leaving them out keeps each count a lower bound of the
work.
"""

from __future__ import annotations

import math

from ..counts import BYTES
from ..weights import VOCAB_PAD

QK_SPREAD = 2.5

_NEUTRAL = ("embedding_multiplier", "residual_multiplier", "logits_scaling")


def dims(c: dict) -> dict:
    """The sizes of a configuration file, by short names."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    e = int(c.get("num_experts") or c.get("num_local_experts") or 0)
    return {
        "D": d, "H": h, "KVH": c["num_key_value_heads"],
        "hd": int(c.get("head_dim") or d // h),
        "F": c["intermediate_size"], "V": c["vocab_size"],
        "Vp": -(-c["vocab_size"] // VOCAB_PAD) * VOCAB_PAD,
        "L": c["num_hidden_layers"], "E": e,
        "k": int(c.get("num_experts_per_tok") or 0),
        "Fe": int(c.get("moe_intermediate_size") or 0),
        "Fs": int(c.get("shared_expert_intermediate_size") or 0),
        "tie": bool(c.get("tie_word_embeddings")),
        "bias": bool(c.get("attention_bias")),
    }


def layout(c: dict) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, std) of every leaf; kind is "w" (normal * std),
    "scale" (1 + std * normal) or "bias" (std * normal)."""
    s = dims(c)
    if c.get("decoder_sparse_step", 1) != 1:
        raise ValueError("only decoders whose every layer is alike are laid "
                         "out here")
    D, H, KVH, hd, L = s["D"], s["H"], s["KVH"], s["hd"], s["L"]
    qk = math.sqrt(QK_SPREAD) / math.sqrt(D)
    out = [(("embed",), (s["Vp"], D), "w", 1 / math.sqrt(D)),
           (("final_norm", "scale"), (D,), "scale", 0.1)]
    if not s["tie"]:
        out.append((("unembed",), (s["Vp"], D), "w", 1 / math.sqrt(D)))
    lay = ("layers", 0)
    out += [(lay + ("ln1", "scale"), (L, D), "scale", 0.1),
            (lay + ("ln2", "scale"), (L, D), "scale", 0.1),
            (lay + ("attn", "wq"), (L, D, H, hd), "w", qk),
            (lay + ("attn", "wk"), (L, D, KVH, hd), "w", qk),
            (lay + ("attn", "wv"), (L, D, KVH, hd), "w", 1 / math.sqrt(D)),
            (lay + ("attn", "wo"), (L, H, hd, D), "w", 1 / math.sqrt(H * hd))]
    if s["bias"]:
        out += [(lay + ("attn", "bq"), (L, H, hd), "bias", 0.1),
                (lay + ("attn", "bk"), (L, KVH, hd), "bias", 0.1),
                (lay + ("attn", "bv"), (L, KVH, hd), "bias", 0.1)]

    def mlp(path, f, *lead):
        return [(path + ("wu",), (L, *lead, D, f), "w", 1 / math.sqrt(D)),
                (path + ("wg",), (L, *lead, D, f), "w", 1 / math.sqrt(D)),
                (path + ("wd",), (L, *lead, f, D), "w", 1 / math.sqrt(f))]

    if s["E"]:
        m = lay + ("mlp",)
        out.append((m + ("router",), (L, D, s["E"]), "w", 1 / math.sqrt(D)))
        out += mlp(m, s["Fe"], s["E"])
        if s["Fs"]:
            out += mlp(m + ("shared",), s["Fs"])
            out.append((m + ("shared_gate",), (L, D, 1), "w",
                        1 / math.sqrt(D)))
    else:
        out += mlp(lay + ("mlp",), s["F"])
    return out


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


class Counts:
    """Counts for one configuration file of this family."""

    def __init__(self, c: dict):
        s = self.s = dims(c)
        self.w = BYTES[c["torch_dtype"]]
        D, H, KVH, hd = s["D"], s["H"], s["KVH"], s["hd"]
        self.attn_params = 2 * D * H * hd + 2 * D * KVH * hd
        if s["E"]:
            self.expert_params = 3 * D * s["Fe"]
            shared = 3 * D * s["Fs"] + D if s["Fs"] else 0
            self.dense_mlp_params = D * s["E"] + shared
            self.active_mlp_params = (self.dense_mlp_params
                                      + s["k"] * self.expert_params)
        else:
            self.expert_params = 0
            self.dense_mlp_params = self.active_mlp_params = 3 * D * s["F"]
        # parameters a token passes through in one layer
        self.layer_active = self.attn_params + self.active_mlp_params
        self.bias_params = (H + 2 * KVH) * hd if s["bias"] else 0
        # every layer runs attention
        self.attn_layers = s["L"]

    # ------------------------------------------------------------- #
    def kv_bytes_per_token(self) -> int:
        """K and V of one token in every layer."""
        s = self.s
        return s["L"] * 2 * s["KVH"] * s["hd"] * self.w

    def weight_bytes(self) -> int:
        """Bytes of every weight, as served (the padded vocabulary rows
        left out)."""
        s = self.s
        per_layer = (self.attn_params + self.dense_mlp_params
                     + s["E"] * self.expert_params + self.bias_params
                     + 2 * s["D"])
        emb = s["V"] * s["D"] * (1 if s["tie"] else 2)
        return (s["L"] * per_layer + emb + s["D"]) * self.w

    # ------------------------------------------------------------- #
    def flash_flops(self, n: int) -> int:
        """A causal flash call over n tokens: 2*n^2*hd*H (QK^T and PV,
        each half of the n x n square)."""
        s = self.s
        return 2 * n * n * s["hd"] * s["H"]

    def flash_bytes(self, n: int) -> int:
        """Q, K, V read once and O written once."""
        s = self.s
        return n * (2 * s["H"] + 2 * s["KVH"]) * s["hd"] * self.w

    def decode_attn_flops(self, lengths) -> int:
        """One decode call: 4*len*H*hd for each live slot."""
        s = self.s
        return 4 * sum(lengths) * s["H"] * s["hd"]

    def decode_attn_bytes(self, lengths) -> int:
        """The K/V rows up to each live slot's length, its query and its
        output."""
        s = self.s
        kv = sum(lengths) * 2 * s["KVH"] * s["hd"]
        return (kv + 2 * len(lengths) * s["H"] * s["hd"]) * self.w

    # ------------------------------------------------------------- #
    def prefill_flops(self, n: int) -> int:
        """A prefill of n tokens that emits one token."""
        s = self.s
        return (2 * n * s["L"] * self.layer_active
                + s["L"] * self.flash_flops(n) + 2 * s["D"] * s["V"])

    def decode_flops(self, lengths) -> int:
        """A decode step over live slots of these lengths (context after
        the step's token is written), each emitting one token."""
        s = self.s
        n = len(lengths)
        return (2 * n * (s["L"] * self.layer_active + s["D"] * s["V"])
                + s["L"] * self.decode_attn_flops(lengths))

    def experts_touched(self, tokens: int) -> float:
        """Expected distinct experts of a layer that `tokens` tokens route
        to, each to top-k distinct experts, uniformly."""
        s = self.s
        if not s["E"]:
            return 0.0
        return s["E"] * (1.0 - ((s["E"] - s["k"]) / s["E"]) ** tokens)

    def prefill_bytes(self, n: int) -> float:
        """Weights read once (the experts the n tokens route to), the
        prompt's K/V written once."""
        return self._weights_read(n) + n * self.kv_bytes_per_token()

    def decode_bytes(self, lengths) -> float:
        """Weights read once (the experts the step's tokens route to), the
        K/V rows each live slot attends over, and its new row written."""
        n = len(lengths)
        kvpt = self.kv_bytes_per_token()
        return self._weights_read(n) + (sum(lengths) + n) * kvpt

    def _weights_read(self, tokens: int) -> float:
        s = self.s
        per_layer = (self.attn_params + self.dense_mlp_params
                     + self.experts_touched(tokens) * self.expert_params
                     + self.bias_params + 2 * s["D"])
        # the unembedding (tied or not), and each token's embedding row
        return (s["L"] * per_layer + s["V"] * s["D"]
                + tokens * s["D"]) * self.w
