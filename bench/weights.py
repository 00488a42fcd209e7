"""The served weights, drawn by the benchmark from `--seed` on the device.

One flat buffer in the served type is filled by one `normal_` call from a
`torch.Generator` on the device; each leaf is a view of it, scaled in
place. The tree is the layout `ServeEngine` takes (`params["layers"]` a
list with one dict of block-stacked leaves for a decoder whose every
layer is alike). Both the program and the reference get these tensors.

Scales: a weight's std is 1/sqrt(its contraction width); the query and
key projections are sqrt(QK_SPREAD) times that, so that scores spread by
about QK_SPREAD and attention is neither uniform nor one-hot; norm scales
are 1 + 0.1 normal, biases 0.1 normal (so that a dropped scale or bias
shows in the comparison); the vocabulary is padded to a multiple of 128
rows, as the program's embedding is.
"""

from __future__ import annotations

import math

import torch

QK_SPREAD = 2.5
VOCAB_PAD = 128

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


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


def make(c: dict, seed: int, device) -> dict:
    """The weight tree of configuration `c` on `device`, from `seed`."""
    dtype = _DTYPES[c["torch_dtype"]]
    leaves = layout(c)
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    tree: dict = {}
    at = 0
    for path, shape, kind, std in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        t.mul_(std)
        if kind == "scale":
            t.add_(1.0)
        node = tree
        for key in path[:-1]:
            if key == 0:
                continue
            node = node.setdefault(key, {})
        node[path[-1]] = t
    layers = tree.pop("layers")
    tree["layers"] = [layers]
    return tree


def nbytes(tree) -> int:
    """Bytes of the weight tree's leaves."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()
