"""The sharded dry run of the other seven archs, and the batch-1 decode
step, against the reference's GSPMD lowering on a (2, 4) ("data",
"model") mesh, per device: tests/test_torch_dryrun_mesh_parity.py's two
programs (`_run_both`) and checks (`check_*`) on

  * REDUCED qwen2-vl-72b, qwen2-moe-a2.7b, jamba-1.5-large-398b,
    rwkv6-3b, deepseek-coder-33b, starcoder2-7b and llama3-405b x decode,
    prefill and train at `ShapeConfig("t", 64, 8, kind)`;
  * the decode step at global batch 1 (`ShapeConfig("t", 64, 1,
    "decode")`, the layout of the `long_500k` cells: the batch does not
    divide "data") of mixtral-8x7b, jamba-1.5-large-398b, rwkv6-3b and
    starcoder2-7b, the four archs that run `long_500k`, and of
    granite-3-8b.

Each serving cell's dot FLOPs equal the reference's less `NAMED`,
exactly; every 2-D product of a batch-8 decode cell runs on B/2 rows;
each train cell is within the one-device band of the net reference; the
dominant roofline term equals the reference's but in `DOMINANT_DIFFERS`.
At batch 1 each product contracts over "data" against its weight's FSDP
shard where GSPMD's does (`Shardings.stationary`).

`python tests/test_torch_dryrun_mesh_parity_zoo.py` prints the cells'
tables.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dryrun_mesh_parity import (_F32, _KV, _KV_TRAIN,  # noqa: E402
                                           _MOE, Named, _run_both,
                                           check_batch_shard, check_dominant,
                                           check_named, check_serving,
                                           check_train_band, table)

ARCHS = ("qwen2-vl-72b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
         "rwkv6-3b", "deepseek-coder-33b", "starcoder2-7b", "llama3-405b")
LONG = ("mixtral-8x7b", "jamba-1.5-large-398b", "rwkv6-3b", "starcoder2-7b",
        "granite-3-8b")
CELLS = [f"{a}/{k}" for a in ARCHS for k in ("decode", "prefill", "train")] \
    + [f"{a}/decode@1" for a in LONG]
#: processes a side: the cells split three ways, the six run at once
PROCS = 3

_Q_DECODE = ("jamba's decode step: GSPMD gathers wq whole and computes "
             "every q head on each model device (granite's it splits); the "
             "port keeps wq's heads over model and gathers q")
_KV_B1 = ("2 KV heads do not divide the 4-way model axis: GSPMD keeps wk "
          "and wv whole over model and contracts the token over 'data' "
          "against their FSDP shard; the port also splits their 32 "
          "columns over model and gathers K and V")
_Q_B1 = ("jamba's batch-1 decode step: GSPMD computes every q head on "
         "each model device, contracting over 'data'; the port keeps wq's "
         "heads over model")
_WKV = ("REDUCED rwkv6-3b's 4 wkv heads divide the 4-way model axis: "
        "GSPMD reduces r, k and v whole and runs the recurrence of every "
        "head on each model device; the port runs each device's head "
        "(`Shardings.local_with`) and gathers its output and the new "
        "state (at full width 40 heads do not divide a 16-way axis: both "
        "run them whole)")

_WO = ("GSPMD gathers wo (its columns over model) whole and computes "
       "all of the output projection on each model device; the port keeps "
       "wo's columns over model and gathers the output (the reference's "
       "shapes are shared with the decay LoRA's second product, whole on "
       "both sides)")

_KV_REF, _KV_PORT = ((256, 64), (64, 32)), ((256, 64), (64, 8))
_WKV_PREFILL = (
    (((4, 4, 16, 8), (4, 4, 8, 16)), ((4, 4, 16, 16), (4, 4, 16, 8)),
     ((4, 4, 8, 16), (4, 4, 16, 8)), ((4, 4, 16, 8), (4, 4, 8, 8)),
     ((4, 16), (4, 16, 32))),
    (((32, 16, 8), (32, 8, 16)), ((32, 8, 16), (32, 16, 16)),
     ((32, 8, 16), (32, 16, 8)), ((32, 8, 8), (32, 8, 16)),
     ((1, 256, 16), (1, 16, 1))))
_WKV_TRAIN = (
    (((4, 4, 16, 16), (4, 4, 16, 8)), ((4, 4, 8, 16), (4, 4, 16, 8)),
     ((4, 4, 16, 8), (4, 4, 8, 16)), ((4, 4, 16, 8), (4, 4, 8, 8)),
     ((4, 4, 16, 8), (4, 4, 16, 16)), ((4, 4, 8, 8), (4, 4, 8, 16)),
     ((4, 16), (4, 16, 32)), ((4, 32), (4, 32, 16))),
    (((32, 8, 16), (32, 16, 16)), ((32, 16, 8), (32, 8, 16)),
     ((32, 8, 8), (32, 8, 16)), ((32, 8, 16), (32, 16, 8)),
     ((32, 16, 16), (32, 16, 8)), ((32, 16, 8), (32, 8, 8)),
     ((1, 256, 16), (1, 16, 1)), ((4, 1, 16, 16), (4, 1, 16, 16)),
     ((4, 8, 8, 1, 16), (4, 8, 8, 1, 16)), ((1, 16, 256), (1, 256, 1)),
     ((1, 256, 1), (1, 1, 16))))


def _kv(cell, op, count, ref_flops, port_flops, cause=_KV):
    return Named(cell, op, _KV_REF, _KV_PORT, count, ref_flops,
                 port_flops, cause)


def _kv_b1(arch, count):
    return Named(f"{arch}/decode@1", "k, v projections", ((32,), (32, 32)),
                 ((1, 32), (32, 8)), count, 2048 * count, 512 * count,
                 _KV_B1)


#: every per-device product the port computes with less work than the
#: reference (FLOPs over all blocks; train: forward, remat, backward)
NAMED = [
    *(_kv(f"{a}/prefill", "k, v projections", 4, 4_194_304, 1_048_576)
      for a in ("qwen2-vl-72b", "deepseek-coder-33b", "starcoder2-7b",
                "llama3-405b")),
    *(_kv(f"{a}/train", "one of the k, v projections", 4, 4_194_304,
          1_048_576, _KV_TRAIN)
      for a in ("deepseek-coder-33b", "llama3-405b")),
    _kv("jamba-1.5-large-398b/prefill", "k, v projections", 2, 2_097_152,
        524_288),
    _kv("jamba-1.5-large-398b/train", "k, v projections", 4, 4_194_304,
        1_048_576),
    Named("jamba-1.5-large-398b/decode", "q projection", ((4, 64), (64, 64)),
          ((4, 64), (64, 16)), 1, 32_768, 8_192, _Q_DECODE,
          shared=229_376),
    Named("jamba-1.5-large-398b/decode@1", "q projection",
          ((32,), (32, 64)), ((1, 32), (32, 16)), 1, 4_096, 1_024, _Q_B1,
          shared=57_344),
    _kv_b1("jamba-1.5-large-398b", 2),
    *(_kv_b1(a, 4) for a in ("mixtral-8x7b", "starcoder2-7b",
                             "granite-3-8b")),
    Named("rwkv6-3b/decode", "output projection", ((4, 64), (64, 64)),
          ((4, 64), (64, 16)), 2, 65_536, 16_384, _WO, shared=65_536),
    Named("rwkv6-3b/decode@1", "output projection", ((64,), (64, 64)),
          ((1, 64), (64, 16)), 2, 16_384, 4_096, _WO, shared=16_384),
    Named("rwkv6-3b/prefill", "output projection", ((256, 64), (64, 64)),
          ((256, 64), (64, 16)), 2, 4_194_304, 1_048_576, _WO,
          shared=4_194_304),
    Named("rwkv6-3b/decode", "wkv recurrence",
          (((4, 4, 16), (4, 4, 16, 16)),), (((4, 1, 16), (4, 16, 16)),), 0,
          16_384, 4_096, _WKV),
    Named("rwkv6-3b/decode@1", "wkv recurrence",
          (((4, 16), (4, 16, 16)),), (((1, 1, 16), (1, 16, 16)),), 0,
          4_096, 1_024, _WKV),
    Named("rwkv6-3b/prefill", "wkv recurrence (chunked)", *_WKV_PREFILL, 0,
          3_211_264, 802_816, _WKV),
    Named("rwkv6-3b/train", "wkv recurrence (chunked, with its backward)",
          *_WKV_TRAIN, 0, 12_779_520, 3_256_320, _WKV),
]

_STATE = ("the port gathers each layer's new f32 wkv state into its cache "
          "leaf (4,096 B a layer; see the wkv entry of NAMED), where GSPMD, "
          "running every head on each device, moves none")

#: cell -> (reference's dominant term, port's, cause)
DOMINANT_DIFFERS = {
    **{f"{a}/train": ("collective", "memory", _F32)
       for a in ("qwen2-vl-72b", "deepseek-coder-33b", "starcoder2-7b",
                 "llama3-405b")},
    "qwen2-moe-a2.7b/prefill": ("collective", "memory", _MOE + "; " + _F32),
    "qwen2-moe-a2.7b/train": ("collective", "memory", _MOE + "; " + _F32),
    "rwkv6-3b/decode": ("memory", "collective", _STATE),
    "jamba-1.5-large-398b/decode@1": ("collective", "memory", _F32),
}


@pytest.fixture(scope="module")
def cells():
    return _run_both(CELLS, PROCS)


@pytest.mark.parametrize("n", NAMED, ids=lambda n: f"{n.cell}:{n.op}")
def test_named_differences_are_in_both_programs(n, cells):
    check_named(n, *cells)


@pytest.mark.parametrize("cell", [c for c in CELLS if "train" not in c])
def test_serving_dot_flops_equal_the_reference_but_the_named(cell, cells):
    check_serving(cell, *cells, NAMED)


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith("/decode")])
def test_decode_products_run_on_the_batch_shard(cell, cells):
    check_batch_shard(cell, cells[1])


@pytest.mark.parametrize("cell", [c for c in CELLS if "@1" in c])
def test_batch_one_decode_does_no_more_work_than_the_reference(cell, cells):
    ref, port = cells
    assert port[cell]["dot"] <= ref[cell]["dot"]


@pytest.mark.parametrize("cell", [c for c in CELLS if "train" in c])
def test_train_dot_flops_within_the_one_device_band(cell, cells):
    check_train_band(cell, *cells, NAMED)


@pytest.mark.parametrize("cell", CELLS)
def test_dominant_terms(cell, cells):
    check_dominant(cell, *cells, DOMINANT_DIFFERS)


if __name__ == "__main__":
    print(table(*_run_both(CELLS, PROCS), CELLS, NAMED))
