"""The archs with recurrent scans (jamba's mamba layers, RWKV-6) on a mesh.
Their sharded paths, `mamba_forward`'s chunked scan and `rwkv_time_mix`'s
chunked wkv under `Shardings.local_with`, run in neither the dry run's
CPU tests nor the other mesh tests.

On 2 CPU ranks (gloo, spawned), REDUCED jamba-1.5-large-398b at f32 and
rwkv6-3b at f64 (it has no attention, and the f64 run tells a fault from
f32 rounding, which the chunked wkv's exponentials amplify to ~2e-4 of a
gradient's scale). The train step's loss and gradients (TRAIN_POLICY, a
32-token batch of 4: the chunked routes) on a (1, 2) and a (2, 1) mesh
against one device: at f32 the loss within 1e-5 and each gradient leaf
within 1e-4 of its own max |g| (tests/test_torch_train_parity.py's
GRAD_TOL); at f64 both within 1e-9. Serving (DECODE_POLICY) a 16-token
prefill (chunked) and 3 decode steps on the same meshes: logits within
1e-5 (f32) or 1e-9 (f64) of their scale. tests/test_torch_dryrun_scan.py
traces the same archs' cells on a fake mesh.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH="src")
ARCHS = {"jamba-1.5-large-398b": "float32", "rwkv6-3b": "float64"}
# (loss, gradient leaf, logits) bands, each of its own scale but the loss
TOL = {"float32": (1e-5, 1e-4, 1e-5), "float64": (1e-9, 1e-9, 1e-9)}

_TWO_RANKS = """
import dataclasses, json, sys
import torch
import torch.distributed as dist

def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x

def grads(cfg, shd):
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models import init_params
    from repro_torch.models.sharding import tree_map
    from repro_torch.train import DataConfig, make_batch
    from repro_torch.train.step import value_and_grad
    params = init_params(0, cfg, "cpu", shd)
    batch = make_batch(cfg, ShapeConfig("t", 32, 4, "train"), 0,
                       DataConfig(), "cpu", shd)
    loss, g = value_and_grad(params, batch, cfg, shd)
    out = []
    tree_map(lambda t: out.append(full(t).double()), g,
             is_leaf=torch.is_tensor)
    return float(full(loss)), out

def serve(cfg, shd, toks):
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import make_decode_step, make_prefill_step
    params = init_params(0, cfg, "cpu", shd)
    cache = init_cache(cfg, toks.shape[0], 24, "cpu", shd)
    place = (lambda t: t) if shd is None else (
        lambda t: shd.place(t, shd.batch_spec(t.shape)))
    logits, cache = make_prefill_step(cfg, shd)(
        params, cache, {"tokens": place(toks[:, :16])})
    out = [logits]
    step = make_decode_step(cfg, shd)
    for i in range(3):
        logits, cache = step(params, cache, place(toks[:, 16 + i:17 + i]))
        out.append(logits)
    return [full(o) for o in out]

def worker(rank, port, path, archs, dtypes):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import REDUCED
    from repro_torch.models import DECODE_POLICY, TRAIN_POLICY, Shardings
    res = {}
    for arch, dtype in zip(archs, dtypes):
        cfg = dataclasses.replace(REDUCED[arch], dtype=dtype)
        toks = torch.randint(0, cfg.vocab_size, (4, 24),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32)
        loss1, g1 = grads(cfg, None)
        want = serve(cfg, None, toks)
        for shape in ((1, 2), (2, 1)):
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            loss, g = grads(cfg, Shardings(mesh, TRAIN_POLICY))
            grad_err = max(float((a - b).abs().max())
                           / max(float(b.abs().max()), 1e-30)
                           for a, b in zip(g, g1))
            got = serve(cfg, Shardings(mesh, DECODE_POLICY), toks)
            res[f"{arch}/{shape}"] = {
                "loss": abs(loss - loss1), "grad": grad_err,
                "leaves": [len(g), len(g1)],
                "logits": max(float((a - b).abs().max())
                              / float(b.abs().max())
                              for a, b in zip(got, want))}
    if rank == 0:
        json.dump(res, open(path, "w"))
    dist.destroy_process_group()

if __name__ == "__main__":
    import torch.multiprocessing as mp
    from repro_torch.launch.elastic import _free_port
    mp.spawn(worker, args=(_free_port(), sys.argv[1], sys.argv[2].split(","),
                           sys.argv[3].split(",")), nprocs=2, join=True)
"""


def test_scan_archs_on_two_ranks_match_one_device(tmp_path):
    script = tmp_path / "two_ranks.py"
    script.write_text(_TWO_RANKS)
    out = tmp_path / "err.json"
    r = subprocess.run([sys.executable, str(script), str(out),
                        ",".join(ARCHS), ",".join(ARCHS.values())], env=ENV,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    errs = json.load(open(out))
    assert len(errs) == 2 * len(ARCHS)
    for cell, e in errs.items():
        loss, grad, logits = TOL[ARCHS[cell.split("/")[0]]]
        assert e["leaves"][0] == e["leaves"][1] > 0, (cell, e)
        assert e["loss"] < loss, (cell, e)
        assert e["grad"] < grad, (cell, e)
        assert e["logits"] < logits, (cell, e)
