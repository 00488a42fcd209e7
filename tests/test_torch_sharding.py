"""The port's sharding layer (`repro_torch.models.sharding`) against the
reference's, with no devices: both packages resolve the same logical
kinds on the production meshes ((16, 16) and (2, 16, 16), jax's
`AbstractMesh` and the port's), for all ten archs and six policies
(TRAIN_POLICY, DECODE_POLICY, and TRAIN_POLICY with kv_layout="batch",
pad_uneven_heads, expert_parallel, shard_vocab=False).

Held equal, leaf for leaf in tree order: `param_specs` and the `dropped`
messages in their order; `input_specs` and `cache_specs` (shapes, dtypes,
specs) for the four shapes; `tokens_in`; `opt_specs` and
`train_shardings`. Then `batch_spec`'s fall back at global batch 1,
`placements` (pod-major), and DTensor local shapes over a fake process
group of 256 ranks equal to the spec's division on divisible dims."""

import dataclasses
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.models import sharding as jsh
from repro.models import transformer as jT
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.models import sharding as tsh
from repro_torch.models import transformer as tT
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ARCHS = sorted(jconfigs.ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = {"train": {}, "decode": None, "kv_batch": {"kv_layout": "batch"},
            "pad_heads": {"pad_uneven_heads": True},
            "expert_parallel": {"expert_parallel": True},
            "no_vocab": {"shard_vocab": False}}


def _policies(variant):
    if variant == "decode":
        return jsh.DECODE_POLICY, tsh.DECODE_POLICY
    kw = VARIANTS[variant]
    return (dataclasses.replace(jsh.TRAIN_POLICY, **kw),
            dataclasses.replace(tsh.TRAIN_POLICY, **kw))


def _shardings(mesh, variant):
    shape, names = MESHES[mesh]
    jpol, tpol = _policies(variant)
    return (jsh.Shardings(JAbstractMesh(shape, names), jpol),
            tsh.Shardings(tsh.AbstractMesh(shape, names), tpol))


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP)
                           or x is None)


def _tleaves(tree, is_leaf=lambda x: isinstance(x, tsh.PartitionSpec)
             or x is None):
    out = []
    tsh.tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def _spec(s):
    return None if s is None else tuple(s)


def _meta_leaves(tree):
    import torch
    return [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in _tleaves(tree, is_leaf=torch.is_tensor)]


def _struct_leaves(tree):
    return [(tuple(s.shape), str(np.dtype(s.dtype)))
            for s in jax.tree.leaves(tree)]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, mesh, variant):
    jshd, tshd = _shardings(mesh, variant)
    jcfg, tcfg = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]

    jp, tp = jT.param_specs(jcfg, jshd), tT.param_specs(tcfg, tshd)
    assert [_spec(s) for s in _tleaves(tp)] == \
        [_spec(s) for s in _jleaves(jp)]
    assert tshd.dropped == jshd.dropped

    jps, tps = jT.param_shape_structs(jcfg), tT.param_shape_structs(tcfg)
    assert _meta_leaves(tps) == _struct_leaves(jps)

    for shape_name, jshape in jshapes.SHAPES.items():
        tshape = tshapes.SHAPES[shape_name]
        assert tshapes.tokens_in(tshape) == jshapes.tokens_in(jshape)
        js, jspec = jshapes.input_specs(jcfg, jshape, jshd)
        ts, tspec = tshapes.input_specs(tcfg, tshape, tshd)
        assert list(ts) == list(js)
        assert _meta_leaves(ts) == _struct_leaves(js)
        assert {k: _spec(v) for k, v in tspec.items()} == \
            {k: _spec(v) for k, v in jspec.items()}
        jc, jcs = jshapes.cache_specs(jcfg, jshape, jshd)
        tc, tcs = tshapes.cache_specs(tcfg, tshape, tshd)
        assert _meta_leaves(tc) == _struct_leaves(jc)
        assert [_spec(s) for s in _tleaves(tcs)] == \
            [_spec(s) for s in _jleaves(jcs)]
    assert tshd.dropped == jshd.dropped

    jtp, jto = jstep.train_shardings(jcfg, jshd)
    ttp, tto = tstep.train_shardings(tcfg, tshd)
    assert [_spec(s) for s in _tleaves(tto)] == \
        [_spec(s) for s in _jleaves(jto)]
    assert [_spec(s) for s in _tleaves(topt.opt_specs(ttp))] == \
        [_spec(s) for s in _jleaves(jopt.opt_specs(jtp))]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_falls_back_at_batch_one(mesh):
    jshd, tshd = _shardings(mesh, "train")
    for shape in ((1, 4096), (256, 4096), (3, 7)):
        assert _spec(tshd.batch_spec(shape)) == _spec(jshd.batch_spec(shape))
    assert tshd.dropped == jshd.dropped
    assert tuple(_shardings(mesh, "train")[1].batch_spec((1, 4096))) == ()
    assert tshd.dropped[0] == "batch[1]%{}!=0 (batch)".format(
        16 if mesh == "single" else 32)


def test_no_mesh_is_a_no_op():
    import torch
    shd = tsh.Shardings(None)
    x = torch.ones(2, 3)
    assert shd.act(x, "batch", None) is x
    assert tuple(shd.spec((4, 8), ("batch", "tp"))) == ()
    assert shd.named((4, 8), ("batch", "tp")) is None
    assert shd.local(lambda t: t + 1, x).sum() == 12
    assert shd.tp_size() == 1


def test_placements_are_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tsh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec = tsh.P(("pod", "data"), None, "model")
    assert tsh.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements(tsh.P(("data", "pod")), mesh)


_LOCAL_SHAPES = textwrap.dedent("""
    import json, torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import _stand_in
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import Shardings, TRAIN_POLICY
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import tree_map
    mesh = make_production_mesh()
    out = []
    for arch in ("granite-3-8b", "mixtral-8x7b", "whisper-tiny"):
        cfg = ARCHS[arch]
        shd = Shardings(mesh, TRAIN_POLICY)
        specs = []
        tree_map(specs.append, T.param_specs(cfg, shd),
                 is_leaf=lambda x: isinstance(x, tuple))
        metas = []
        tree_map(metas.append, T.param_shape_structs(cfg),
                 is_leaf=torch.is_tensor)
        for spec, m in zip(specs, metas):
            d = _stand_in(m, spec, mesh)
            out.append([list(m.shape), [e if e is None or isinstance(e, str)
                        else list(e) for e in spec],
                        list(d.to_local().shape), list(d.shape)])
    with torch.no_grad():
        w = torch.empty((4096, 14336), dtype=torch.bfloat16, device="meta")
        d = _stand_in(w, ("data", "model"), mesh)
        out.append([[4096, 14336], ["data", "model"],
                    list(d.to_local().shape), list(d.shape)])
    # an activation constraint that drops its rule, met on every layer of
    # every step: kept once in act_dropped, never in dropped
    shd = Shardings(mesh, TRAIN_POLICY)
    x = _stand_in(torch.empty((3, 4096), device="meta"), (), mesh)
    for _ in range(5):
        assert shd.act(x, "batch", None) is x
    acts = {"dropped": shd.dropped, "act_dropped": list(shd.act_dropped)}
    print(json.dumps(acts))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def local_shapes_run():
    """The script above over a fake process group of 256 ranks, in a
    subprocess (the group is process-wide): its two JSON lines."""
    r = subprocess.run([sys.executable, "-c", _LOCAL_SHAPES],
                       capture_output=True, text=True, timeout=300,
                       env={**__import__("os").environ,
                            "PYTHONPATH": "src"})
    assert r.returncode == 0, r.stderr[-3000:]
    import json
    return [json.loads(x) for x in r.stdout.strip().splitlines()[-2:]]


def test_dtensor_local_shapes_divide_the_spec(local_shapes_run):
    """Each parameter's DTensor shard is its global shape divided by the
    axis sizes its spec names, dim by dim."""
    rows = local_shapes_run[1]
    sizes = {"data": 16, "model": 16}
    assert len(rows) > 30
    for shape, spec, local, glob in rows:
        assert glob == shape
        spec = spec + [None] * (len(shape) - len(spec))
        for n, e, loc in zip(shape, spec, local):
            axes = [] if e is None else [e] if isinstance(e, str) else e
            div = int(np.prod([sizes[a] for a in axes])) if axes else 1
            assert n % div == 0 and loc == n // div, (shape, spec, local)
    assert rows[-1][2] == [256, 896]


def test_act_records_a_dropped_rule_once(local_shapes_run):
    """`Shardings.act` on a DTensor whose dim does not divide: the rule
    is kept once in `act_dropped`, and `dropped` (the parameter, input
    and cache specs' record) does not grow with the calls."""
    acts = local_shapes_run[0]
    assert acts["dropped"] == []
    assert acts["act_dropped"] == ["act[3]%16!=0 (batch)"]
