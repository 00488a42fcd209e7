"""`repro_torch.launch.mesh` and the model on real DTensors.

* `make_production_mesh`: the (16, 16) and (2, 16, 16) meshes over a fake
  process group of 256 and 512 ranks, one replacing the other, in a
  subprocess (a process group is process-wide); importing the module
  starts none.
* `make_smoke_mesh` on the CPU: a (1, 1) gloo mesh over a one-process
  group it starts.
* Serving on 2 CPU ranks (gloo, spawned): REDUCED granite-3-8b and
  mixtral-8x7b at f32 under DECODE_POLICY, a 20-token prefill and 3
  decode steps on a (1, 2) mesh (the cache's sequence split in two:
  sharded cache writes, flash-decoding merge of the decode kernel's
  halves; mixtral's 16-slot window ring past its wrap) and on a (2, 1)
  mesh (rows split: the MoE scatter on each rank's rows), logits within
  1e-5 of the unmeshed run's.
* A decode step on a (2, 1) gloo mesh: every product of the first block
  on each rank's B/2 rows (`census.program_units` of the step), logits
  within 1e-5 of one device's.
"""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH="src")


def _run(code, timeout=300):
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       env=ENV, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_production_meshes_over_fake_groups():
    out = json.loads(_run("""
        import json
        import torch.distributed as dist
        import repro_torch.launch as L
        started = dist.is_initialized()
        a = L.make_production_mesh()
        sa = [tuple(a.shape), a.mesh_dim_names, dist.get_world_size(),
              dist.get_backend()]
        b = L.make_production_mesh(multi_pod=True)
        sb = [tuple(b.shape), b.mesh_dim_names, dist.get_world_size()]
        print(json.dumps([started, sa, sb]))
    """))
    assert out == [False, [[16, 16], ["data", "model"], 256, "fake"],
                   [[2, 16, 16], ["pod", "data", "model"], 512]]


def test_smoke_mesh_on_the_cpu():
    out = json.loads(_run("""
        import json
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_smoke_mesh
        m = make_smoke_mesh(device="cpu")
        print(json.dumps([tuple(m.shape), m.mesh_dim_names,
                          dist.get_backend(), dist.get_world_size()]))
    """))
    assert out == [[1, 1], ["data", "model"], "gloo", 1]


_SERVE = """
import dataclasses, json, sys
import torch
import torch.distributed as dist

def serve(cfg, shd, toks):
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import make_decode_step, make_prefill_step
    params = init_params(0, cfg, "cpu", shd)
    cache = init_cache(cfg, toks.shape[0], 24, "cpu", shd)
    inputs = {"tokens": toks[:, :20]}
    if shd is not None:
        inputs = {"tokens": shd.place(inputs["tokens"],
                                      shd.batch_spec(inputs["tokens"].shape))}
    logits, cache = make_prefill_step(cfg, shd)(params, cache, inputs)
    out = [logits]
    step = make_decode_step(cfg, shd)
    for i in range(3):
        t = toks[:, 20 + i:21 + i]
        if shd is not None:
            t = shd.place(t, shd.batch_spec(t.shape))
        logits, cache = step(params, cache, t)
        out.append(logits)
    return [o.full_tensor() if hasattr(o, "full_tensor") else o
            for o in out]

def worker(rank, port, path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import REDUCED
    from repro_torch.models import DECODE_POLICY, Shardings
    res = {}
    for arch in ("granite-3-8b", "mixtral-8x7b"):
        cfg = dataclasses.replace(REDUCED[arch], dtype="float32")
        toks = torch.randint(0, cfg.vocab_size, (4, 24),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32)
        want = serve(cfg, None, toks)
        for shape in ((1, 2), (2, 1)):
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            got = serve(cfg, Shardings(mesh, DECODE_POLICY), toks)
            res[f"{arch}/{shape}"] = max(
                float((g - w).abs().max()) for g, w in zip(got, want))
    if rank == 0:
        json.dump(res, open(path, "w"))
    dist.destroy_process_group()

if __name__ == "__main__":
    import torch.multiprocessing as mp
    from repro_torch.launch.elastic import _free_port
    mp.spawn(worker, args=(_free_port(), sys.argv[1]), nprocs=2, join=True)
"""


def test_serving_on_two_ranks_matches_one_device(tmp_path):
    script = tmp_path / "serve2.py"
    script.write_text(_SERVE)
    out = tmp_path / "err.json"
    r = subprocess.run([sys.executable, str(script), str(out)], env=ENV,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    errs = json.load(open(out))
    assert len(errs) == 4
    for cell, err in errs.items():
        assert err < 1e-5, (cell, err)


_LAYOUT = """
import dataclasses, json, sys
import torch
import torch.distributed as dist

def worker(rank, port, path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import REDUCED
    from repro_torch.core import census
    from repro_torch.models import (DECODE_POLICY, Shardings, init_cache,
                                    init_params)
    from repro_torch.serve import make_decode_step, make_prefill_step
    cfg = dataclasses.replace(REDUCED["granite-3-8b"], dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (4, 21),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    out = {}
    for name, shd in (("one", None), ("mesh", Shardings(mesh, DECODE_POLICY))):
        params = init_params(0, cfg, "cpu", shd)
        cache = init_cache(cfg, 4, 24, "cpu", shd)
        put = (lambda t: t) if shd is None else \\
            (lambda t: shd.place(t, shd.batch_spec(t.shape)))
        _, cache = make_prefill_step(cfg, shd)(params, cache,
                                               {"tokens": put(toks[:, :20])})
        step, tok = make_decode_step(cfg, shd), put(toks[:, 20:])
        if shd is not None:
            prog = census.trace_program(step, params, cache, tok)
            out["products"] = [[list(v.shape) for v in u.ops[0].ins[:2]]
                               for u in census.program_units(prog)
                               if u.kind == "dot"]
        logits, _ = step(params, cache, tok)
        out[name] = logits.full_tensor() if shd is not None else logits
    if rank == 0:
        json.dump({"err": float((out["mesh"] - out["one"]).abs().max()),
                   "products": out["products"]}, open(path, "w"))
    dist.destroy_process_group()

if __name__ == "__main__":
    import torch.multiprocessing as mp
    from repro_torch.launch.elastic import _free_port
    mp.spawn(worker, args=(_free_port(), sys.argv[1]), nprocs=2, join=True)
"""


def test_decode_products_on_the_row_shard_of_a_2x1_mesh(tmp_path):
    """A decode step on a (2, 1) gloo mesh (rows split over "data"): every
    product of the first block runs on each rank's B/2 = 2 rows, K and V
    as (2, d) @ (d, KVH x hd) with the weight gathered (the embedding
    gather's output once fed them as a product over all 4 rows, the
    contraction split over "data"), and the logits are within 1e-5 of
    one device's."""
    script = tmp_path / "layout.py"
    script.write_text(_LAYOUT)
    out = tmp_path / "layout.json"
    r = subprocess.run([sys.executable, str(script), str(out)], env=ENV,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    got = json.load(open(out))
    assert got["err"] < 1e-5, got["err"]
    q, k, v = got["products"][:3]
    assert q == [[2, 64], [64, 64]]
    assert k == v == [[2, 64], [64, 32]]
    assert all(lhs[0] == 2 for lhs, _ in got["products"] if len(lhs) == 2)
