"""Multi-pod dry run: trace every (arch x shape) step on the production
meshes, count one device's program, and emit the roofline terms, in the
reference's record format (`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch all --shape all --mesh both --out runs/dryrun.json
    ... --arch llama3-405b --shape train_4k --mesh multi -v
    ... --policy kv_layout=batch --policy seq_parallel_acts=1

Each cell's step (the train step with AdamW, the prefill step or the
decode step) runs once on DTensors over the (16, 16) or (2, 16, 16) mesh
of `launch.mesh.make_production_mesh`: a fake process group of 256 or 512
ranks in this one process, every local shard a fake tensor (shapes and
dtypes, no storage), so nothing is computed and nothing touches the card.
`core.census` records rank 0's local ops and the collectives DTensor
issues: that is the per-device program the reference compiles. Each
attention kernel (flash forward and backward, decode) counts as one op
(`kernels.ops.kernel_ops`): its products and the bytes it moves, not the
score-sized intermediates of its plain version, which no kernel holds
(the reference's dry run takes its chunked flash for the same reason).
`lower_s` is that trace's time. `compile_s` is 0.0: there is no compile
step, PyTorch runs its ops eagerly. `memory_analysis` gives the device's
argument, output and temp bytes (`census.memory`: the peak of live
temporaries over the op sequence). The roofline is on `TPU_V5E`, the
modelled machine of the reference: its seconds are a modelled pod's,
not the card's.

The fake process group starts in `main()`, never at import.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, get_arch
from ..configs.shapes import (SHAPES, ShapeConfig, cache_specs, input_specs,
                              skip_reason, tokens_in)
from ..core import census
from ..core.pim_model import TPU_V5E
from ..core.roofline import (roofline_from_analysis, render_markdown_table,
                             what_would_move_it)
from ..dist import local_extent
from ..kernels import ops
from ..models import (DECODE_POLICY, TRAIN_POLICY, ModelConfig, Policy,
                      Shardings, param_shape_structs, param_specs,
                      placements, torch_dtype)
from ..models.sharding import P, tree_map
from ..serve import make_decode_step, make_prefill_step
from ..train import HParams, make_train_step
from ..train.optimizer import opt_specs


def _stand_in(meta: torch.Tensor, spec, mesh):
    """A DTensor of `meta`'s global shape and dtype, laid out by `spec`,
    whose local shard is a `meta` tensor of the device's shape."""
    from torch.distributed.tensor import DTensor
    plc = placements(spec if spec is not None else P(), mesh)
    shape, _ = local_extent(meta.shape, mesh, plc)
    local = torch.empty(shape, dtype=meta.dtype, device="meta")
    return DTensor.from_local(local, mesh, plc, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _stand_ins(structs, specs, mesh):
    flat_specs = []
    tree_map(flat_specs.append, specs,
             is_leaf=lambda x: x is None or isinstance(x, P))
    it = iter(flat_specs)
    return tree_map(lambda t: _stand_in(t, next(it), mesh), structs,
                    is_leaf=torch.is_tensor)


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def _group(cfg: ModelConfig) -> int:
    """Blocks per remat group (1 where the group does not divide the
    blocks, as `models.transformer.stack_forward` runs them)."""
    g = max(cfg.remat_group, 1)
    return g if cfg.n_blocks % g == 0 else 1


def _with_blocks(cfg: ModelConfig, n: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=n * len(cfg.layer_pattern()))


def _trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh, shd):
    """Trace one cell's step on stand-ins over `mesh` (census.Program),
    each attention kernel one op (`ops.kernel_ops`)."""
    with ops.kernel_ops():
        return _trace(cfg, shape, mesh, shd)


def _trace(cfg: ModelConfig, shape: ShapeConfig, mesh, shd):
    pspecs = param_specs(cfg, shd)
    params = _stand_ins(param_shape_structs(cfg), pspecs, mesh)
    in_structs, in_spec_tree = input_specs(cfg, shape, shd)
    batch = _stand_ins(in_structs, in_spec_tree, mesh)
    if shape.kind == "train":
        mdt = torch_dtype(cfg.opt_moment_dtype)
        moments = tree_map(lambda t: torch.empty(t.shape, dtype=mdt,
                                                 device="meta"),
                           param_shape_structs(cfg), is_leaf=torch.is_tensor)
        ostructs = {"m": moments, "v": moments,
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}
        opt = _stand_ins(ostructs, opt_specs(pspecs), mesh)
        step = make_train_step(cfg, HParams(), shd=shd)
        return census.trace_program(step, params, opt, batch)
    cstructs, cspecs = cache_specs(cfg, shape, shd)
    cache = _stand_ins(cstructs, cspecs, mesh)
    if shape.kind == "prefill":
        return census.trace_program(make_prefill_step(cfg, shd), params,
                                    cache, batch)
    return census.trace_program(make_decode_step(cfg, shd), params, cache,
                                batch["tokens"])


def _counts(prog) -> dict:
    """The linear counts of one traced program: the census's totals, the
    memory terms, and the collectives grouped by (opcode, operand bytes,
    group) with their number."""
    an = census.analyze(prog)
    colls: dict = {}
    for c in an.collectives:
        key = (c.opcode, c.bytes, c.group_size, c.replica_groups)
        colls.setdefault(key, [0, c.op_name])[0] += 1
    return {"an": an, "mem": census.memory(prog), "colls": colls,
            "flops": an.flops, "dot_flops": an.dot_flops,
            "hbm_bytes": an.hbm_bytes,
            "collective_bytes": an.collective_bytes}


def _extrapolate(one: dict, two: dict, groups: int) -> dict:
    """Counts of `groups` remat groups from traces of one and of two: the
    first group's counts plus (groups - 1) times the second's, the way the
    reference multiplies its scan body by the trip count (every group
    after the first runs the same ops on the same shapes)."""
    k = groups - 1
    lin = lambda a, b: a + k * (b - a)
    out = {n: lin(one[n], two[n]) for n in
           ("flops", "dot_flops", "hbm_bytes", "collective_bytes")}
    out["mem"] = {n: int(lin(one["mem"][n], two["mem"][n]))
                  for n in one["mem"]}
    colls = {}
    for key in set(one["colls"]) | set(two["colls"]):
        a = one["colls"].get(key, [0, ""])
        b = two["colls"].get(key, [0, ""])
        n = int(lin(a[0], b[0]))
        if n > 0:
            colls[key] = [n, b[1] or a[1]]
    out["colls"] = colls
    out["an"] = two["an"]
    return out


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               policy: Policy | None = None, verbose: bool = False,
               full_depth: bool = False):
    """Trace one (arch, shape, mesh) cell's step and count it. Returns
    (record dict, RooflineReport).

    Where the stack has more than four remat groups (and not
    `full_depth`), the step is traced at one group and at two, and the
    counts and memory terms are extrapolated to the full depth
    (`_extrapolate`); the argument and output bytes are the full model's
    either way. `lower_s` is the time of the traces."""
    t0 = time.perf_counter()
    pol = policy or (TRAIN_POLICY if shape.kind == "train" else DECODE_POLICY)
    shd = _spec_drops(cfg, shape, Shardings(mesh, pol))
    n_chips = mesh.size()
    g = _group(cfg)
    groups = cfg.n_blocks // g
    traced = Shardings(mesh, pol)
    if full_depth or groups <= 4:           # no cheaper than 1 + 2 groups
        counts = _counts(_trace_step(cfg, shape, mesh, traced))
    else:
        one = _counts(_trace_step(_with_blocks(cfg, g), shape, mesh, traced))
        two = _counts(_trace_step(_with_blocks(cfg, 2 * g), shape, mesh,
                                  Shardings(mesh, pol)))
        counts = _extrapolate(one, two, groups)
        counts["mem"].update(_io_bytes(cfg, shape, mesh,
                                       Shardings(mesh, pol)))
    # the constraints' dropped rules once each (the reference traces its
    # scanned body once; the port's loop meets them every layer)
    shd.dropped += traced.act_dropped
    t_lower = time.perf_counter() - t0

    an = dataclasses.replace(
        counts["an"], flops=counts["flops"], dot_flops=counts["dot_flops"],
        hbm_bytes=counts["hbm_bytes"],
        collective_bytes=counts["collective_bytes"],
        collectives=[census.CollectiveInfo(op, b * n, n, gs, grp, name)
                     for (op, b, gs, grp), (n, name)
                     in counts["colls"].items()])
    mem = counts["mem"]
    cost = {"flops": an.flops, "bytes accessed": an.hbm_bytes}
    mf = cfg.model_flops(tokens=tokens_in(shape),
                         train=(shape.kind == "train"))
    name = f"{cfg.name}/{shape.name}"
    # analytic minimum bytes the step must stream (global; roofline
    # divides by chips): params once (+grads/moments for train, active
    # params only for MoE decode), plus the KV/state cache for serving
    bp = _itemsize(cfg.dtype)
    bm = _itemsize(cfg.opt_moment_dtype)
    if shape.kind == "train":
        model_bytes = cfg.param_count() * (3 * bp + 4 * bm)
    else:
        active = cfg.param_count(active_only=(shape.kind == "decode"))
        cache_b = sum(t.numel() * t.element_size() for t in
                      _leaves(cache_specs(cfg, shape, None)[0]))
        model_bytes = active * bp + cache_b
    report = roofline_from_analysis(an, name=name, n_chips=n_chips,
                                    model_flops=mf, model_bytes=model_bytes,
                                    machine=TPU_V5E)
    # HBM residency per device: params (+moments when training)
    resident = cfg.param_count() * bp
    if shape.kind == "train":
        resident += 2 * cfg.param_count() * bm
    resident /= n_chips

    colls = sorted(an.collectives, key=lambda c: -c.bytes)
    rec = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
        "n_chips": n_chips,
        "status": "ok",
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "memory_analysis": mem,
        "cost_analysis": cost,
        "resident_bytes_per_device_est": int(resident),
        "dropped_shardings": shd.dropped[:20],
        "roofline": report.to_row(),
        "collectives": [dataclasses.asdict(c) for c in colls[:12]],
        "flops_per_device": an.flops,
        "hbm_bytes_per_device": an.hbm_bytes,
        "collective_bytes_per_device": an.collective_bytes,
        "guidance": what_would_move_it(report),
    }
    if verbose:
        print(f"  memory_analysis: {mem}")
        print(f"  cost_analysis:   {cost}")
        print(f"  roofline:        {report.to_row()}")
        print(f"  guidance:        {rec['guidance']}")
    return rec, report


def _spec_drops(cfg: ModelConfig, shape: ShapeConfig, shd: Shardings):
    """`shd` after resolving the cell's specs in the reference's order, so
    its `dropped` lists their rules as the reference's record does: the
    parameters, the inputs, then the parameters again for the optimizer
    state (train) or the cache and the logits (serving)."""
    param_specs(cfg, shd)
    input_specs(cfg, shape, shd)
    if shape.kind == "train":
        param_specs(cfg, shd)
    else:
        cache_specs(cfg, shape, shd)
        shd.spec((shape.global_batch, cfg.vocab_size), ("batch", "vocab"),
                 "logits")
    return shd


def _leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree, is_leaf=torch.is_tensor)
    return out


def _io_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh, shd) -> dict:
    """One device's argument and output bytes of the full-depth step: the
    local shards of its parameters (and optimizer state) or cache, and
    its inputs; the train step returns its metrics, a serving step the
    last logits row of its rows."""
    def local_bytes(structs, specs):
        flat: list = []
        tree_map(flat.append, specs,
                 is_leaf=lambda x: x is None or isinstance(x, P))
        total = 0
        for t, spec in zip(_leaves(structs), flat):
            shp, _ = local_extent(t.shape, mesh,
                                  placements(spec or P(), mesh))
            total += math.prod(shp) * t.element_size()
        return total
    pstructs = param_shape_structs(cfg)
    pspecs = param_specs(cfg, shd)
    args = local_bytes(pstructs, pspecs)
    ins, ispecs = input_specs(cfg, shape, shd)
    if shape.kind == "decode":
        ins, ispecs = {"tokens": ins["tokens"]}, {"tokens": ispecs["tokens"]}
    args += local_bytes(ins, ispecs)
    if shape.kind == "train":
        args += 2 * local_bytes(
            tree_map(lambda t: torch.empty(
                t.shape, dtype=torch_dtype(cfg.opt_moment_dtype),
                device="meta"), pstructs, is_leaf=torch.is_tensor),
            pspecs) + 4
        return {"argument_size_in_bytes": args}
    cstructs, cspecs = cache_specs(cfg, shape, shd)
    return {"argument_size_in_bytes": args + local_bytes(cstructs, cspecs)}


def _parse_policy(kvs: list[str], base: Policy) -> Policy:
    changes = {}
    for kv in kvs:
        k, v = kv.split("=", 1)
        if k not in {f.name for f in dataclasses.fields(Policy)}:
            raise KeyError(f"no Policy field {k!r}")
        if isinstance(getattr(base, k), bool):
            changes[k] = v not in ("0", "false", "False")
        elif isinstance(getattr(base, k), tuple):
            changes[k] = tuple(x for x in v.split(",") if x)
        else:
            changes[k] = v
    return dataclasses.replace(base, **changes)


def main(argv=None) -> int:
    from .mesh import make_production_mesh
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--policy", action="append", default=[],
                    help="Policy overrides, e.g. kv_layout=batch")
    ap.add_argument("--remat-group", type=int, default=0,
                    help="override every arch's remat_group (0 = config)")
    ap.add_argument("--out", default="")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records, reports = [], []
    failures = 0
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_name = "multi(2,16,16)" if multi_pod else "single(16,16)"
        for arch in archs:
            cfg = get_arch(arch)
            if args.remat_group:
                cfg = dataclasses.replace(cfg, remat_group=args.remat_group)
            for shape_name in shapes:
                shape = SHAPES[shape_name]
                reason = skip_reason(cfg, shape)
                tag = f"{cfg.name:22s} x {shape.name:12s} @ {mesh_name}"
                if reason:
                    print(f"SKIP {tag}: {reason}")
                    records.append({"arch": cfg.name, "shape": shape.name,
                                    "mesh": mesh_name, "status": "skip",
                                    "reason": reason})
                    continue
                try:
                    pol_base = (TRAIN_POLICY if shape.kind == "train"
                                else DECODE_POLICY)
                    pol = _parse_policy(args.policy, pol_base) \
                        if args.policy else None
                    rec, rep = lower_cell(cfg, shape, mesh, pol,
                                          args.verbose)
                    rec["mesh_name"] = mesh_name
                    records.append(rec)
                    if not multi_pod:
                        reports.append(rep)  # roofline table: single-pod
                    r = rec["roofline"]
                    print(f"OK   {tag}: trace={rec['lower_s']:.1f}s "
                          f"dominant={r['dominant']} "
                          f"frac={r['roofline_fraction']:.3f}", flush=True)
                except Exception as e:
                    failures += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                    if args.verbose:
                        traceback.print_exc()
                    records.append({"arch": cfg.name, "shape": shape.name,
                                    "mesh": mesh_name, "status": "fail",
                                    "error": f"{type(e).__name__}: {e}"})

    if reports:
        print("\n## Roofline (single-pod, modelled TPU v5e)\n")
        print(render_markdown_table(reports))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"\nwrote {len(records)} records -> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
