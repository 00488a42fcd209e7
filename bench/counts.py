"""The work the inputs need, from a configuration's shapes and the tokens
the driver sent and received: FLOPs and HBM bytes of a prefill, of a
decode step, and of each attention kernel call.

What is counted is what the inputs need, not what the program happens to
do: the unembedding once per emitted token (not over every prompt
position); a decode call's K/V rows up to each live slot's own length
(a slot that holds no request needs none); in the MoE layer the top-k
experts of each token for FLOPs and, for bytes, the experts a step's
tokens route to (the expected number of distinct experts under uniform
routing: the benchmark does not see the router). A product of m x n by
n x p is 2mnp FLOPs. Norms, RoPE, softmax and other elementwise work,
and activations' bytes, are left out: they are a small share at these
widths, and leaving them out keeps each count a lower bound of the work.
"""

from __future__ import annotations

from .weights import dims

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


class Counts:
    """Counts for one configuration file."""

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
