"""A configuration file's `reference` names its family (`bench.families`)
beside its plain reference: the decoder family gives what the harness
gave before the family code moved (`decoder_golden`: the layout, the
program's config, every count and the drawn weights byte for byte), and
a family added as files alone runs a cell, its config, layout, counts,
attention layer count and reference the ones used."""

import dataclasses
import hashlib
import importlib.util
import json
import math
import sys
import time

import pytest
import torch

from bench import counts, manifest, readers, weights
from bench.manifest import Manifest
from bench.model import model_config
from bench.run import run_cell
from bench.tests import decoder_golden as golden
from bench.tests.tiny import (BENCH, CLOSED, DEEP_DENSE, DEEP_MOE, DENSE,
                               MOE, ROOT, make_tree)


def _cfg(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


CONFIGS = {"granite-3-8b": _cfg("granite-3-8b"),
           "qwen2-moe-a2.7b": _cfg("qwen2-moe-a2.7b"), "dense": DENSE,
           "moe": MOE, "deep-dense": DEEP_DENSE, "deep-moe": DEEP_MOE}
PROMPTS = (1, 17, 1024, 3968)
SLOTS = ((1,), (10, 20), (128,) * 16, tuple(range(100, 4100, 64)))


def count_values(c: dict) -> dict:
    """Every count of configuration `c` on the grid of prompt lengths and
    live slots' lengths."""
    k = counts.Counts(c)
    return {
        "kv_bytes_per_token": k.kv_bytes_per_token(),
        "weight_bytes": k.weight_bytes(),
        "flash_flops": [k.flash_flops(n) for n in PROMPTS],
        "flash_bytes": [k.flash_bytes(n) for n in PROMPTS],
        "prefill_flops": [k.prefill_flops(n) for n in PROMPTS],
        "prefill_bytes": [k.prefill_bytes(n) for n in PROMPTS],
        "experts_touched": [k.experts_touched(n) for n in PROMPTS],
        "decode_attn_flops": [k.decode_attn_flops(ls) for ls in SLOTS],
        "decode_attn_bytes": [k.decode_attn_bytes(ls) for ls in SLOTS],
        "decode_flops": [k.decode_flops(ls) for ls in SLOTS],
        "decode_bytes": [k.decode_bytes(ls) for ls in SLOTS],
    }


def tree_sha(tree) -> str:
    """SHA-256 of a weight tree: its shape of dicts and lists, and each
    leaf's path, dtype, shape and bytes, dict keys in sorted order."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        elif isinstance(node, list):
            h.update(f"list{len(node)}".encode())
            for i, sub in enumerate(node):
                walk(sub, path + (i,))
        else:
            h.update(repr((path, str(node.dtype), tuple(node.shape)))
                     .encode())
            h.update(node.contiguous().view(torch.uint8).cpu().numpy())

    walk(tree, ())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layout_is_the_decoders_as_before(name):
    assert weights.layout(CONFIGS[name]) == golden.LAYOUT[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_config_is_the_decoders_as_before(name):
    from repro_torch.models import ModelConfig
    assert model_config(CONFIGS[name]) == \
        ModelConfig(**golden.MODEL_CONFIG[name])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counts_are_the_decoders_as_before(name):
    assert count_values(CONFIGS[name]) == golden.COUNTS[name]
    assert counts.Counts(CONFIGS[name]).attn_layers == \
        CONFIGS[name]["num_hidden_layers"]


@pytest.mark.parametrize("name,seed", sorted(golden.SHA))
def test_weights_are_drawn_byte_for_byte_as_before(name, seed):
    tree = weights.make(CONFIGS[name], seed, "cpu")
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == 1
    assert tree_sha(tree) == golden.SHA[name, seed]


def test_integer_keys_are_list_positions(monkeypatch):
    """A layout with two pattern positions gives the program's list of
    two dicts, drawn in layout order from one buffer."""
    from bench.families import decoder
    two = [(("embed",), (3, 2), "w", 1.0),
           (("layers", 0, "a"), (2,), "scale", 0.0),
           (("layers", 1, "b", "w"), (2, 2), "w", 1.0),
           (("layers", 1, "c"), (1,), "bias", 1.0)]
    monkeypatch.setattr(decoder, "layout", lambda c: two)
    tree = weights.make(dict(DENSE, torch_dtype="float32"), 9, "cpu")
    assert list(tree) == ["embed", "layers"]
    assert [sorted(x) for x in tree["layers"]] == [["a"], ["b", "c"]]
    assert torch.equal(tree["layers"][0]["a"], torch.ones(2))
    flat = torch.empty(13).normal_(generator=torch.Generator()
                                   .manual_seed(9))
    assert torch.equal(tree["layers"][1]["b"]["w"].flatten(), flat[8:12])
    assert torch.equal(tree["layers"][1]["c"], flat[12:])


SPY = '''"""A family for the tests: the decoder's, recording which of its parts
the harness calls, with an attention layer count of its own."""

from bench.families import decoder

CALLS = []
ATTN_LAYERS = 1


def model_config(c):
    CALLS.append("model_config")
    return decoder.model_config(c)


def layout(c):
    CALLS.append("layout")
    return decoder.layout(c)


class Counts(decoder.Counts):
    def __init__(self, c):
        CALLS.append("Counts")
        super().__init__(c)
        self.attn_layers = ATTN_LAYERS
'''

SPY_REFERENCE = '''"""The decoder's plain reference under the test family's name."""

from bench.reference import decoder

CALLS = []


def logits_at(*args, **kwargs):
    CALLS.append("logits_at")
    return decoder.logits_at(*args, **kwargs)
'''


def _add_spy_cell(root):
    """The family and reference files, a configuration that names them and
    a closed-loop cell on it, added to the checkout as files and entries
    alone."""
    (root / "bench" / "families" / "spy_decoder.py").write_text(SPY)
    (root / "bench" / "reference" / "spy_decoder.py").write_text(
        SPY_REFERENCE)
    cfg = dict(DENSE, name="granite-spy", reference="spy_decoder")
    (root / "bench" / "configs" / "granite-spy.json").write_text(
        json.dumps(cfg))
    (root / "bench" / "workloads" / "spy.closed.json").write_text(
        json.dumps(CLOSED))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "granite-spy", "source": "test",
                            "file": "bench/configs/granite-spy.json",
                            "reduced": [], "why": "test"})
    data["workloads"].append({"name": "spy.closed", "config": "granite-spy",
                              "traffic": "closed", "chips": 1, "why": "test"})
    for m in data["end_to_end"] + data["per_layer"]:
        if "granite-3-8b.decode-64" in m.get("workloads", []):
            m["workloads"].append("spy.closed")
    (root / "BENCHMARK.json").write_text(json.dumps(data, indent=1))


def _load(monkeypatch, root, folder):
    """Module `bench.<folder>.spy_decoder` from the checkout's file."""
    spec = importlib.util.spec_from_file_location(
        f"bench.{folder}.spy_decoder",
        root / "bench" / folder / "spy_decoder.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_a_family_added_as_a_file_runs_a_cell(tmp_path, monkeypatch):
    root = make_tree(tmp_path, "float32")
    _add_spy_cell(root)
    man = Manifest(root)
    assert manifest.problems(man.data, root) == []
    # the checkout's files, loaded where the harness looks for them
    spy, spy_ref = (_load(monkeypatch, root, folder) for folder in
                    ("families", "reference"))

    out, run = run_cell(man, "spy.closed", 2**31 + 9, 0.5, True,
                        device="cpu", t_start=time.perf_counter(),
                        log=lambda m: None)
    assert out["correct"] and out["failed"] == 0
    assert spy.CALLS == ["model_config", "layout", "Counts"]
    assert spy_ref.CALLS == ["logits_at"]
    assert type(run.counts) is spy.Counts
    assert run.counts.attn_layers == 1 != DENSE["num_hidden_layers"]

    # the roofline counts the family's attention layers, not its layers
    pk = {"bf16_flops": 1e12, "hbm_bytes_s": 1e9}
    traced = dataclasses.replace(
        run, peaks=pk, slice={"t_start": -math.inf, "t_end": math.inf,
                              "kernel_s": {"decode_split_kernel": 2.0}})
    c = run.counts
    least = sum(max(c.decode_attn_flops(ls) / pk["bf16_flops"],
                    c.decode_attn_bytes(ls) / pk["hbm_bytes_s"])
                for _, _, ls in run.steps if ls)
    assert least > 0
    assert readers.roofline(traced, "decode") == \
        pytest.approx(100.0 * spy.ATTN_LAYERS * least / 2.0, rel=1e-12)


def test_no_harness_file_names_a_model_or_a_layer_kind():
    """The dispatchers leave the family's matter to its module."""
    for name in ("model.py", "weights.py", "counts.py"):
        text = (BENCH / name).read_text().lower()
        for word in ("granite", "qwen", "moe", "expert", "attention",
                     "attn", "mlp", "decoder", "mamba"):
            assert word not in text, (name, word)
