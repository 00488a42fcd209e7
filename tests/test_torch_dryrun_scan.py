"""The dry run's cells of the archs with recurrent scans (jamba's mamba
layers, RWKV-6) on a (2, 4) fake mesh, in a subprocess (a process group
is process-wide): REDUCED jamba-1.5-large-398b and rwkv6-3b, `lower_cell`
of the train and prefill steps, status `ok` on 8 chips with positive
per-device dot FLOPs, the train steps with collectives, and for prefill 8
x the per-device dot FLOPs >= the one-device program's. No recorded op
computes on the whole batch of 8: the ops DTensor runs on global-shape
stand-ins to find a strategy through an op's decomposition (mamba's
softplus backward) are not the program's. (The full-size
cells trace in minutes; a one-device trace of jamba's train step would
take this file past a minute, so train is held on the mesh alone.)
tests/test_torch_mesh_scan.py runs the same archs on 2 gloo ranks.
"""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH="src")
ARCHS = ("jamba-1.5-large-398b", "rwkv6-3b")

_FAKE_MESH = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import REDUCED
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun as D
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    one = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    dots = {}
    orig = D._counts
    def keep(prog):
        c = orig(prog)
        dots["last"] = c["dot_flops"]
        # arithmetic on the whole batch of 8: none is the program's
        dots["whole"] = sum(
            op.name in ("exp", "mul", "add") and any(
                len(v.shape) >= 3 and v.shape[0] == 8 for v in op.outs)
            for op in prog.ops)
        return c
    D._counts = keep
    out = {}
    for arch in %r:
        for kind in ("train", "prefill"):
            shape = ShapeConfig("t", 16, 8, kind)
            rec, _ = D.lower_cell(REDUCED[arch], shape, mesh)
            d8, d1, whole = dots["last"], None, dots["whole"]
            if kind == "prefill":
                rec1, _ = D.lower_cell(REDUCED[arch], shape, one)
                d1 = dots["last"]
            out[f"{arch}/{kind}"] = [rec["status"], d8, d1, rec["n_chips"],
                                     rec["collective_bytes_per_device"],
                                     len(rec["collectives"]), whole]
    print(json.dumps(out))
""" % (ARCHS,))


def test_scan_cells_on_a_2x4_fake_mesh():
    r = subprocess.run([sys.executable, "-c", _FAKE_MESH], env=ENV,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(out) == 2 * len(ARCHS)
    for cell, (status, d8, d1, chips, coll, n_coll, whole) in out.items():
        assert status == "ok" and chips == 8 and d8 > 0, (cell, out[cell])
        assert whole == 0, (cell, out[cell])
        if cell.endswith("/train"):
            assert coll > 0 and n_coll > 0, (cell, out[cell])
        else:
            assert chips * d8 >= d1 > 0, (cell, out[cell])
