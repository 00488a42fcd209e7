"""A benchmark tree at CPU sizes for the tests: the real `bench/` copied
beside a manifest whose cells use tiny configurations, which are added
as files only, as a later change would add a cell."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

DENSE = {
    "name": "granite-tiny", "source": "test", "reference": "decoder",
    "model_type": "granite", "hidden_size": 64, "intermediate_size": 160,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 515,
    "max_position_embeddings": 256, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": True, "attention_multiplier": 0.25,
    "torch_dtype": "float32"}

MOE = {
    "name": "qwen2-moe-tiny", "source": "test", "reference": "decoder",
    "model_type": "qwen2_moe", "hidden_size": 64, "intermediate_size": 160,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 4, "head_dim": 16, "vocab_size": 512,
    "max_position_embeddings": 256, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
    "hidden_act": "silu", "num_experts": 6, "num_experts_per_tok": 2,
    "moe_intermediate_size": 48, "shared_expert_intermediate_size": 160,
    "decoder_sparse_step": 1, "norm_topk_prob": True,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "attention_bias": True, "shared_expert_gate": "sigmoid",
    "moe_capacity_factor": 1.25}

OPEN = {
    "why": "test", "loop": "open", "slots": 4, "max_len": 128,
    "rate_rps": 40.0,
    "prompt_tokens": {"dist": "loguniform", "lo": 16, "hi": 64},
    "output_tokens": {"dist": "uniform", "lo": 2, "hi": 6},
    "trace": {"start_s": 0.1, "length_s": 0.3},
    "check": {"requests": 12, "limit": {"logit_gap": 0.05}}}

CLOSED = {
    "why": "test", "loop": "closed", "clients": 4, "slots": 4, "max_len": 128,
    "prompt_tokens": {"dist": "loguniform", "lo": 8, "hi": 32},
    "output_tokens": {"dist": "uniform", "lo": 8, "hi": 24},
    "trace": {"start_s": 0.1, "length_s": 0.3},
    "check": {"requests": 12, "limit": {"logit_gap": 0.05}}}


# Deeper cells in bfloat16 held to the limits of the committed cells they
# stand for: deep enough and with enough served tokens that the float8
# control's gaps grow past those limits, as they do at the cells' size.
DEEP_DENSE = dict(DENSE, name="granite-deep", hidden_size=256,
                  intermediate_size=640, num_hidden_layers=24,
                  num_attention_heads=16, num_key_value_heads=8,
                  vocab_size=16384, torch_dtype="bfloat16")

DEEP_MOE = dict(MOE, name="qwen2-moe-deep", hidden_size=128,
                intermediate_size=320, num_hidden_layers=12,
                num_attention_heads=8, num_key_value_heads=8,
                vocab_size=16384, num_experts=60, num_experts_per_tok=4,
                moe_intermediate_size=32,
                shared_expert_intermediate_size=320, torch_dtype="bfloat16")

LONG = dict(CLOSED, clients=8, slots=8, max_len=256,
            prompt_tokens={"dist": "loguniform", "lo": 16, "hi": 64},
            output_tokens={"dist": "uniform", "lo": 24, "hi": 64})

#: seconds a deep cell's window runs: some hundreds of served tokens in
#: the sample on a CPU
DEEP_S = 8.0

#: deep cell -> the committed cell whose `check` block it takes
STANDS_FOR = {"deep-dense.closed": "granite-3-8b.decode-64",
              "deep-moe.closed": "qwen2-moe-a2.7b.decode-64"}


def make_tree(tmp: Path, dtype: str = "float32", limit: float = 0.05,
              moe_number: str = "logit_gap") -> Path:
    """A checkout root under `tmp` holding the real benchmark plus the
    tiny configurations and cells (`tiny-dense.open`, `tiny-dense.closed`,
    `tiny-moe.closed`, whose compared number is `moe_number`, and the
    deep cells of `STANDS_FOR` under their committed cells' checks),
    added as files and manifest entries alone."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {"tiny-dense.open": ("granite-tiny", "open", OPEN),
             "tiny-dense.closed": ("granite-tiny", "closed", CLOSED),
             "tiny-moe.closed": ("qwen2-moe-tiny", "closed", CLOSED),
             "deep-dense.closed": ("granite-deep", "closed", LONG),
             "deep-moe.closed": ("qwen2-moe-deep", "closed", LONG)}
    for c in (dict(DENSE, torch_dtype=dtype), dict(MOE, torch_dtype=dtype),
              DEEP_DENSE, DEEP_MOE):
        path = f"bench/configs/{c['name']}.json"
        (root / path).write_text(json.dumps(c))
        data["configs"].append({"name": c["name"], "source": "test",
                                "file": path, "reduced": [], "why": "test"})
    for name, (cfg, traffic, mix) in cells.items():
        mix = copy.deepcopy(mix)
        number = moe_number if cfg == MOE["name"] else "logit_gap"
        mix["check"]["limit"] = {number: limit}
        if name in STANDS_FOR:
            mix["check"] = json.loads(
                (BENCH / "workloads" / f"{STANDS_FOR[name]}.json")
                .read_text())["check"]
        (root / "bench" / "workloads" / f"{name}.json").write_text(
            json.dumps(mix))
        data["workloads"].append({"name": name, "config": cfg,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
        for m in data["end_to_end"] + data["per_layer"]:
            kinds = m.get("workloads")
            if kinds is None:
                continue
            like = ("granite-3-8b.docqa" if traffic == "open"
                    else "granite-3-8b.decode-64")
            if like in kinds:
                kinds.append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(data, indent=1))
    return root
