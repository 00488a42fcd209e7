"""The port's sharded dry run against the reference's GSPMD lowering on a
(2, 4) ("data", "model") mesh, per device.

The reference's `lower_cell` runs on `jax.make_mesh((2, 4), ..., Auto
axes)` over 8 of the host devices its module asks XLA for (it sets its
own `XLA_FLAGS` at import, so it runs in a fresh process); the port's on
a (2, 4) `init_device_mesh` over a fake 8-rank group, in a second process
beside it. Both run REDUCED granite-3-8b, mixtral-8x7b and whisper-tiny x
decode, prefill and train at `ShapeConfig("t", 64, 8, kind)`, and print
each cell's per-device dot FLOPs, its products (operand shapes and
FLOPs, fused dots included) and its collective bytes by kind.

What is held:
  * serving: the port's dot FLOPs equal the reference's less the
    products named in `NAMED`, exactly. Each entry names the op, the
    reference's product (its operand shapes, how many, their FLOPs in
    all, checked against the reference's list) and the port's for the
    same work, smaller, and its cause: every one is work GSPMD computes
    whole on each "model" device where the operands' layout does not
    call for it; the port splits it over "model" as its weights are
    split, and gathers the result;
  * every matrix product of a decode cell runs on the batch shard (B/2
    rows), none over the whole batch;
  * train: the port's dot FLOPs over the reference's less its named
    products within the one-device train band (`TRAIN_DOT_RATIO` /
    `BAND` of tests/test_torch_suitability.py);
  * the roofline's dominant term equals the reference's, save the cells
    in `DOMINANT_DIFFERS`, where it must differ as stated.

`_run_both` (any cells, a batch other than 8 as "arch/kind@batch") and
the `check_*` functions hold the other seven archs and the batch-1
decode cells in tests/test_torch_dryrun_mesh_parity_zoo.py.
`python tests/test_torch_dryrun_mesh_parity.py` prints the cells side by
side: dot FLOPs, collective bytes by kind, roofline terms, dominant term.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_suitability import BAND, TRAIN_DOT_RATIO  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-3-8b", "mixtral-8x7b", "whisper-tiny")
KINDS = ("decode", "prefill", "train")
CELLS = [f"{a}/{k}" for a in ARCHS for k in KINDS]
BATCH, DATA = 8, 2
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_REFERENCE = textwrap.dedent("""
    import json, re, sys
    from repro.launch import dryrun as D
    import jax
    from jax.sharding import AxisType
    from repro.configs import REDUCED
    from repro.configs.shapes import ShapeConfig
    from repro.core import hlo_analysis as H

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:8])

    def coll_f32(mod, acc):
        # collective bytes whose operand is f32
        total = 0
        for c in acc.coll.values():
            for comp in mod.computations.values():
                op = comp.ops.get(c.op_name)
                if op is not None:
                    src = comp.ops.get(op.operands[0])
                    total += c.bytes if src is not None and \
                        src.type_str.startswith("f32") else 0
                    break
        return total

    def dims(t):
        m = re.match(r"\\w+\\[([0-9,]*)\\]", t)
        return [int(v) for v in m.group(1).split(",") if v]

    class Products(H._Accumulator):
        # every dot with its trip multiplier, fused ones included
        def __init__(self, *a):
            super().__init__(*a)
            self.products = []

        def _keep(self, name, m):
            comp = self.module.computations.get(name)
            for op in (comp.ops.values() if comp is not None else ()):
                if op.opcode == "dot":
                    ins = [dims(comp.ops[o].type_str) for o in op.operands]
                    self.products.append(
                        [ins[0], ins[1], H._dot_flops(op, comp) * m])

        def visit(self, name, m, for_traffic=True):
            self._keep(name, m)
            return super().visit(name, m, for_traffic)

        def _visit_fusion_flops(self, name, m):
            self._keep(name, m)
            return super()._visit_fusion_flops(name, m)

    texts = []
    orig = D.analyze_hlo

    def keep(text, **kw):
        texts.append(text)
        return orig(text, **kw)
    D.analyze_hlo = keep
    out = {}
    for cell in sys.argv[1].split(","):
        arch, kind, batch = re.fullmatch(r"(.+)/(\\w+)(?:@(\\d+))?",
                                         cell).groups()
        cfg = REDUCED[arch]
        rec, _ = D.lower_cell(cfg, ShapeConfig("t", 64, int(batch or 8),
                                               kind), mesh)
        mod = H.parse_hlo_text(texts[-1])
        acc = Products(mod, cfg.n_blocks)
        acc.visit(mod.entry, 1.0)
        an = orig(texts[-1], trip_count_fallback=cfg.n_blocks)
        assert acc.dot_flops == an.dot_flops
        out[cell] = {
            "dot": an.dot_flops, "hbm": an.hbm_bytes,
            "coll": an.collective_breakdown,
            "coll_f32": coll_f32(mod, acc),
            "dominant": rec["roofline"]["dominant"],
            "terms": [rec["roofline"][t] for t in
                      ("compute_s", "memory_s", "collective_s")],
            "products": acc.products}
    print(json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import json, re, sys
    from collections import defaultdict
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import REDUCED
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core import census
    from repro_torch.launch import dryrun as D

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    seen = []
    orig = D._counts

    def keep(prog):
        seen.append((prog, orig(prog)))
        return seen[-1][1]
    D._counts = keep
    out = {}
    for cell in sys.argv[1].split(","):
        arch, kind, batch = re.fullmatch(r"(.+)/(\\w+)(?:@(\\d+))?",
                                         cell).groups()
        rec, _ = D.lower_cell(REDUCED[arch], ShapeConfig(
            "t", 64, int(batch or 8), kind), mesh)
        prog, counts = seen[-1]
        coll = defaultdict(float)
        for c in counts["an"].collectives:
            coll[c.opcode] += c.bytes
        products = [[list(u.ops[0].ins[0].shape),
                     list(u.ops[0].ins[1].shape), u.dot_flops, u.kind]
                    for u in census.program_units(prog) if u.dot_flops]
        assert sum(p[2] for p in products) == counts["dot_flops"]
        out[cell] = {
            "dot": counts["dot_flops"], "hbm": counts["hbm_bytes"],
            "coll": dict(coll), "dominant": rec["roofline"]["dominant"],
            "terms": [rec["roofline"][t] for t in
                      ("compute_s", "memory_s", "collective_s")],
            "products": products}
    print(json.dumps(out))
""")


@dataclasses.dataclass(frozen=True)
class Named:
    """A product whose per-device work differs: in `cell`, the
    reference's `count` products of operand shapes `ref` (lhs, rhs) take
    `ref_flops` in all, the port's for the same work (shapes `port`)
    `port_flops`. A batched product (a recurrence's einsums) gives a
    tuple of (lhs, rhs) pairs a side and no count: its FLOPs are the
    sums over those shapes, exact on both sides. `shared`: FLOPs of
    other products of the reference's shapes, which the port runs at
    the same shapes (a token's (D,) row is the port's (1, D))."""
    cell: str
    op: str
    ref: tuple
    port: tuple
    count: int
    ref_flops: int
    port_flops: int
    cause: str
    shared: int = 0


_KV = ("2 KV heads do not divide the 4-way model axis: wk and wv stay "
       "whole on every model device, and GSPMD computes all of K and V "
       "there; the port splits the product's 32 columns over model and "
       "gathers K and V")
_KV_TRAIN = (_KV + " (the other GSPMD splits over the sequence, the "
             "port's work)")
_CROSS_Q = ("the cross-attention query has no constraint: GSPMD gathers "
            "wq whole and computes every head on each model device; the "
            "port keeps wq's heads over model and gathers q")
_CROSS_KV = ("the encoder K/V of the cross-attention have no constraint: "
             "GSPMD gathers wk and wv whole and computes every head on "
             "each model device; the port keeps their heads over model")

#: every per-device product the port computes with less work than the
#: reference; FLOPs over both blocks (train: forward and its remat)
NAMED = [
    Named("granite-3-8b/prefill", "k, v projections", ((256, 64), (64, 32)),
          ((256, 64), (64, 8)), 4, 4_194_304, 1_048_576, _KV),
    Named("mixtral-8x7b/prefill", "k, v projections", ((256, 64), (64, 32)),
          ((256, 64), (64, 8)), 4, 4_194_304, 1_048_576, _KV),
    Named("whisper-tiny/decode", "cross-attention q", ((4, 64), (64, 64)),
          ((4, 64), (64, 16)), 2, 65_536, 16_384, _CROSS_Q),
    Named("whisper-tiny/prefill", "cross-attention q", ((256, 64), (64, 64)),
          ((256, 64), (64, 16)), 2, 4_194_304, 1_048_576, _CROSS_Q),
    Named("whisper-tiny/prefill", "cross-attention k, v",
          ((96, 64), (64, 64)), ((96, 64), (64, 16)), 4, 3_145_728,
          786_432, _CROSS_KV),
    Named("granite-3-8b/train", "one of the k, v projections",
          ((256, 64), (64, 32)), ((256, 64), (64, 8)), 4, 4_194_304,
          1_048_576, _KV_TRAIN),
    Named("mixtral-8x7b/train", "one of the k, v projections",
          ((256, 64), (64, 32)), ((256, 64), (64, 8)), 4, 4_194_304,
          1_048_576, _KV_TRAIN),
    Named("whisper-tiny/train", "cross-attention q", ((256, 64), (64, 64)),
          ((256, 64), (64, 16)), 4, 8_388_608, 2_097_152, _CROSS_Q),
    Named("whisper-tiny/train", "cross-attention k, v",
          ((96, 64), (64, 64)), ((96, 64), (64, 16)), 8, 6_291_456,
          1_572_864, _CROSS_KV),
]

_F32 = ("XLA:CPU runs the reference's bf16 step in f32, so its collectives "
        "carry f32: twice the bytes of the port's bf16 ones")
_MOE = ("GSPMD splits the MoE scatter and gather over model (all-reduces "
        "and permutes of the (B, E, C, D) buffer), where the port runs them "
        "on each device's rows")

#: cell -> (reference's dominant term, port's, cause)
DOMINANT_DIFFERS = {
    "granite-3-8b/train": ("collective", "memory", _F32),
    "mixtral-8x7b/prefill": ("collective", "memory", _MOE + "; " + _F32),
    "mixtral-8x7b/train": ("collective", "memory", _MOE + "; " + _F32),
    "whisper-tiny/prefill": ("collective", "memory", _F32),
    "whisper-tiny/train": ("collective", "memory", _F32),
}


def _run_both(cells=CELLS, procs: int = 1):
    """The reference's and the port's programs on `cells` ("arch/kind",
    or "arch/kind@batch" for a batch other than 8), each side split over
    `procs` processes, all run at once. Returns (ref, port), each
    {cell: counts}."""
    env = dict(os.environ, PYTHONPATH="src")
    parts = [",".join(cells[i::procs]) for i in range(procs)]

    def run(job):
        code, part = job
        r = subprocess.run([sys.executable, "-c", code, part], env=env,
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=400)
        assert r.returncode == 0, r.stderr[-3000:]
        return json.loads(r.stdout.strip().splitlines()[-1])
    jobs = [(code, part) for code in (_REFERENCE, _PORT) for part in parts]
    with ThreadPoolExecutor(len(jobs)) as pool:
        outs = list(pool.map(run, jobs))
    merge = lambda ds: {k: v for d in ds for k, v in d.items()}
    return merge(outs[:procs]), merge(outs[procs:])


@pytest.fixture(scope="module")
def cells():
    return _run_both()


def _pairs(shapes) -> set:
    """The (lhs, rhs) operand shape pairs of a `Named` side."""
    pairs = (shapes,) if isinstance(shapes[0][0], int) else shapes
    return {(tuple(lhs), tuple(rhs)) for lhs, rhs in pairs}


def _flops_at(products, shapes, rows=tuple) -> int:
    """FLOPs of the products of operand shapes in `shapes`, each lhs
    first mapped by `rows`."""
    return sum(p[2] for p in products
               if (rows(p[0]), tuple(p[1])) in shapes)


def _token_rows(lhs) -> tuple:
    """A product's lhs with its leading size-1 dims dropped."""
    lhs = tuple(lhs)
    while len(lhs) > 1 and lhs[0] == 1:
        lhs = lhs[1:]
    return lhs


def _net_reference(ref, cell, named=NAMED):
    """The reference's dot FLOPs with each named product at the port's
    work."""
    return ref[cell]["dot"] - sum(n.ref_flops - n.port_flops
                                  for n in named if n.cell == cell)


def check_named(n: Named, ref, port):
    """`n` is in both programs, its FLOPs as stated, and the port's work
    is the smaller."""
    rs, ps = _pairs(n.ref), _pairs(n.port)
    assert _flops_at(ref[n.cell]["products"], rs) == n.ref_flops + n.shared
    assert n.port_flops < n.ref_flops
    theirs = _flops_at(port[n.cell]["products"], ps)
    if n.count:
        assert n.ref_flops == \
            2 * n.count * math.prod(n.ref[0]) * n.ref[1][1]
        assert n.port_flops == \
            2 * n.count * math.prod(n.port[0]) * n.port[1][1]
        assert theirs >= n.port_flops
    else:
        assert theirs == n.port_flops
    if n.shared:
        assert _flops_at(port[n.cell]["products"], rs,
                         _token_rows) == n.shared


def check_serving(cell, ref, port, named):
    assert port[cell]["dot"] == _net_reference(ref, cell, named)


def check_batch_shard(cell, port):
    for lhs, rhs, _, kind in port[cell]["products"]:
        if kind == "dot" and len(lhs) == 2:
            assert lhs[0] == BATCH // DATA, (lhs, rhs)


def check_train_band(cell, ref, port, named):
    r = port[cell]["dot"] / _net_reference(ref, cell, named)
    assert TRAIN_DOT_RATIO / BAND <= r <= TRAIN_DOT_RATIO * BAND, r


def check_dominant(cell, ref, port, differs):
    pair = (ref[cell]["dominant"], port[cell]["dominant"])
    want = differs.get(cell, (pair[0], pair[0]))
    assert pair == want[:2], pair


@pytest.mark.parametrize("n", NAMED, ids=lambda n: f"{n.cell}:{n.op}")
def test_named_differences_are_in_both_programs(n, cells):
    check_named(n, *cells)


@pytest.mark.parametrize("cell", [c for c in CELLS if "train" not in c])
def test_serving_dot_flops_equal_the_reference_but_the_named(cell, cells):
    check_serving(cell, *cells, NAMED)


@pytest.mark.parametrize("cell", [c for c in CELLS if "decode" in c])
def test_decode_products_run_on_the_batch_shard(cell, cells):
    check_batch_shard(cell, cells[1])


@pytest.mark.parametrize("cell", [c for c in CELLS if "train" in c])
def test_train_dot_flops_within_the_one_device_band(cell, cells):
    check_train_band(cell, *cells, NAMED)


@pytest.mark.parametrize("cell", CELLS)
def test_dominant_terms(cell, cells):
    check_dominant(cell, *cells, DOMINANT_DIFFERS)


def table(ref, port, cells=CELLS, named=NAMED) -> str:
    """Two markdown tables: per cell the dot FLOPs, collective bytes and
    roofline terms; then the collective bytes by kind."""
    rows = ["| cell | ref dot FLOPs | port dot FLOPs | port / net ref | "
            "ref coll. B (f32 share) | port coll. B | ref coll. / mem. term "
            "| port coll. / mem. term | dominant ref / port |",
            "|---" * 9 + "|"]
    for cell in cells:
        r, p = ref[cell], port[cell]
        rc, pc = sum(r["coll"].values()), sum(p["coll"].values())
        rows.append(
            f"| {cell} | {r['dot']:,.0f} | {p['dot']:,.0f} | "
            f"{p['dot'] / _net_reference(ref, cell, named):.4f} | {rc:,.0f} "
            f"({r['coll_f32'] / rc:.3f}) | {pc:,.0f} | "
            f"{r['terms'][2] / r['terms'][1]:.3f} | "
            f"{p['terms'][2] / p['terms'][1]:.3f} | {r['dominant']} / "
            f"{p['dominant']} |")
    rows += ["", "| cell | " + " | ".join(f"{k} ref / port"
                                          for k in COLLECTIVES) + " |",
             "|---" * (1 + len(COLLECTIVES)) + "|"]
    for cell in cells:
        rows.append(f"| {cell} | " + " | ".join(
            f"{ref[cell]['coll'].get(k, 0):,.0f} / "
            f"{port[cell]['coll'].get(k, 0):,.0f}" for k in COLLECTIVES)
            + " |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(table(*_run_both()))
