"""The port's dry run (`repro_torch.launch.dryrun`) against the
reference's.

* On a one-device mesh with Auto axes (the reference's `make_production_mesh`
  fails under jax 0.9.0, ROADMAP F8), the reference's `lower_cell` and
  the port's, at REDUCED granite-3-8b, mixtral-8x7b (an MoE census:
  its combine and capacity positions are reduces on both sides) and
  whisper-tiny, decode, prefill and train (`ShapeConfig("t", 64, 2, kind)`): dot FLOPs equal exactly
  for prefill and decode, the train step's within the band of
  tests/test_torch_suitability.py's train row; `dominant`,
  `resident_bytes_per_device_est`, model FLOPs and model bytes equal.
  The port's side runs over a fake process group of one rank.
* (tests/test_torch_dryrun_cli.py holds the twin of tests/test_dryrun.py;
  tests/test_torch_dryrun_zoo.py the same three checks for the other
  seven archs, through `reference_cells`, `port_cells` and `check_*`.)
* On a (2, 4) fake mesh at REDUCED size (a subprocess): 8 x the
  per-device dot FLOPs >= the one-device program's
  (tests/test_torch_dryrun_mesh_parity.py holds them to the reference's), the train step has
  collectives, and the counts extrapolated from one and two remat groups
  equal the full-depth trace's on a 6-block granite.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch.distributed as dist
from jax.sharding import AxisType

from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.configs.shapes import ShapeConfig as TShape
from repro_torch.launch import dryrun as tdry

from test_torch_suitability import BAND, TRAIN_DOT_RATIO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-8b", "mixtral-8x7b", "whisper-tiny")
KINDS = ("decode", "prefill", "train")


def _reference_dryrun():
    """`repro.launch.dryrun`, imported after jax has its devices (its first
    line sets the 512-device flag for a fresh process; here it must not
    change this one, nor leak into later subprocesses)."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


def reference_cells(archs=ARCHS):
    """{(arch, kind): (record, report, analysis)} of the reference's
    `lower_cell` on a one-device `Auto` mesh."""
    jdry = _reference_dryrun()
    from repro.configs import REDUCED
    from repro.configs.shapes import ShapeConfig
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    seen = []
    orig = jdry.analyze_hlo

    def keep(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]
    jdry.analyze_hlo = keep
    out = {}
    try:
        for arch in archs:
            for kind in KINDS:
                rec, rep = jdry.lower_cell(REDUCED[arch],
                                           ShapeConfig("t", 64, 2, kind),
                                           mesh)
                out[arch, kind] = (rec, rep, seen[-1])
    finally:
        jdry.analyze_hlo = orig
    return out


def port_cells(archs=ARCHS):
    """The port's twin of `reference_cells`, over a fake one-rank group."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=1)
    seen = []
    orig = tdry._counts

    def keep(prog):
        seen.append(orig(prog))
        return seen[-1]
    tdry._counts = keep
    out = {}
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        for arch in archs:
            for kind in KINDS:
                rec, rep = tdry.lower_cell(T_REDUCED[arch],
                                           TShape("t", 64, 2, kind), mesh)
                out[arch, kind] = (rec, rep, seen[-1]["an"])
    finally:
        tdry._counts = orig
        if started:
            dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def reference():
    return reference_cells()


@pytest.fixture(scope="module")
def port():
    return port_cells()


def check_serving(arch, kind, reference, port):
    assert port[arch, kind][2].dot_flops == reference[arch, kind][2].dot_flops


def check_train_band(arch, reference, port):
    r = port[arch, "train"][2].dot_flops / \
        reference[arch, "train"][2].dot_flops
    assert TRAIN_DOT_RATIO / BAND <= r <= TRAIN_DOT_RATIO * BAND, (arch, r)


def check_record_terms(arch, kind, reference, port):
    jrec, jrep, _ = reference[arch, kind]
    trec, trep, _ = port[arch, kind]
    assert set(trec) == set(jrec)
    assert trec["status"] == "ok" and trec["n_chips"] == jrec["n_chips"] == 1
    assert trec["mesh"] == jrec["mesh"]
    assert trec["compile_s"] == 0.0
    assert trec["roofline"]["dominant"] == jrec["roofline"]["dominant"]
    assert trec["resident_bytes_per_device_est"] == \
        jrec["resident_bytes_per_device_est"]
    assert trep.model_flops == jrep.model_flops
    assert trep.model_bytes == jrep.model_bytes
    assert trec["dropped_shardings"] == jrec["dropped_shardings"]
    assert trec["collectives"] == [] and trec["collective_bytes_per_device"] == 0
    mem = trec["memory_analysis"]
    assert set(mem) <= set(jrec["memory_analysis"])
    assert mem["argument_size_in_bytes"] > 0 and \
        mem["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_dot_flops_equal_exactly(arch, kind, reference, port):
    check_serving(arch, kind, reference, port)


def test_train_dot_flops_within_the_suitability_band(reference, port):
    for arch in ARCHS:
        check_train_band(arch, reference, port)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_record_terms_equal_the_reference(arch, kind, reference, port):
    check_record_terms(arch, kind, reference, port)


_SHARDED = textwrap.dedent("""
    import dataclasses, json
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import REDUCED
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun as D
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    one = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    out = {}
    dots = {}
    orig = D._counts
    def keep(prog):
        c = orig(prog)
        dots["last"] = c["dot_flops"]
        return c
    D._counts = keep
    for arch in ("granite-3-8b", "mixtral-8x7b"):
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("t", 64, 8, kind)
            rec, _ = D.lower_cell(REDUCED[arch], shape, mesh)
            d8 = dots["last"]
            rec1, _ = D.lower_cell(REDUCED[arch], shape, one)
            out[f"{arch}/{kind}"] = [d8, dots["last"], rec["n_chips"],
                                     rec["collective_bytes_per_device"],
                                     len(rec["collectives"])]
    cfg = dataclasses.replace(REDUCED["granite-3-8b"], n_layers=6,
                              remat_group=1)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", 64, 8, kind)
        full, _ = D.lower_cell(cfg, shape, mesh, full_depth=True)
        ext, _ = D.lower_cell(cfg, shape, mesh)
        keys = ("flops_per_device", "hbm_bytes_per_device",
                "collective_bytes_per_device")
        out[f"extrapolated/{kind}"] = [[full[k], ext[k]] for k in keys]
    print(json.dumps(out))
""")


def test_sharded_cells_on_a_2x4_mesh():
    r = subprocess.run([sys.executable, "-c", _SHARDED],
                       env=dict(os.environ, PYTHONPATH="src"),
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for cell, vals in out.items():
        if cell.startswith("extrapolated/"):
            for full, ext in vals:
                assert full == ext, (cell, vals)
            continue
        d8, d1, chips, coll, n_coll = vals
        assert chips == 8
        assert chips * d8 >= d1, (cell, vals)
        if cell.endswith("/train"):
            assert coll > 0 and n_coll > 0, (cell, vals)


def test_kernel_ops_count_the_kernels_work():
    """Under `ops.kernel_ops` a flash forward is one op: the plain
    version's values and dot FLOPs, and the bytes of q, k, v in and the
    output and log-sum-exp out (no (B, H, Sq, Skv) scores); the backward
    op gives the plain backward's values."""
    import torch
    from repro_torch.core.census import analyze_program
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 64, 4, 16, generator=gen)
    k, v = (torch.randn(2, 64, 2, 16, generator=gen) for _ in range(2))
    fwd = lambda q, k, v: ops.flash_attention(q, k, v)
    plain = analyze_program(fwd, q, k, v)
    with ops.kernel_ops():
        one = analyze_program(fwd, q, k, v)
        assert torch.equal(fwd(q, k, v), ref.flash_attention(q, k, v))
        out, lse = ref.flash_attention(q, k, v, return_lse=True)
        dout = torch.randn(out.shape, generator=gen)
        got = ops._flash_backward(q, k, v, out, lse, dout, True, 0)
        want = ref.flash_attention_bwd(q, k, v, out, lse, dout, True, 0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert one.dot_flops == plain.dot_flops > 0
    assert one.hbm_bytes == 2 * q.nbytes + k.nbytes + v.nbytes + lse.nbytes
    assert one.hbm_bytes < plain.hbm_bytes


def test_kernel_ops_count_the_decode_kernels_work():
    """Under `ops.kernel_ops` a decode attention is one op: the plain
    version's values, its dot FLOPs (S and P V over all W slots), and the
    bytes of q, k, v and the lengths in and the output and log-sum-exp
    out (no (B, H, W) scores). Its log-sum-exp is the scores' own, in
    f64 on the same inputs; a row's empty slots add nothing to it."""
    import torch
    from repro_torch.core.census import analyze_program
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(3, 8, 16, generator=gen)
    k, v = (torch.randn(3, 40, 2, 16, generator=gen) for _ in range(2))
    lengths = torch.tensor([40, 17, 1], dtype=torch.int32)
    dec = lambda q, k, v, n: ops.decode_attention(q, k, v, n)
    plain = analyze_program(dec, q, k, v, lengths)
    with ops.kernel_ops():
        one = analyze_program(dec, q, k, v, lengths)
        assert torch.equal(dec(q, k, v, lengths),
                           ref.decode_attention(q, k, v, lengths))
        out, lse = ops._decode_forward(q, k, v, lengths, True)
    assert one.dot_flops == plain.dot_flops == 2 * 2 * 3 * 8 * 40 * 16
    assert one.hbm_bytes == 2 * q.nbytes + k.nbytes + v.nbytes + \
        lengths.nbytes + lse.nbytes
    assert one.hbm_bytes < plain.hbm_bytes
    qg = q.double().reshape(3, 2, 4, 16)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.double()) / 4.0
    want = torch.stack([torch.logsumexp(s[b, ..., :n], -1).reshape(8)
                        for b, n in enumerate(lengths.tolist())])
    assert lse.shape == (3, 8) and lse.dtype == torch.float32
    assert torch.allclose(lse.double(), want, atol=1e-5, rtol=0)
