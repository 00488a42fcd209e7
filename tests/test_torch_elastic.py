"""`repro_torch.launch.elastic` on CPU ranks of a gloo process group.

* The twin of tests/test_elastic.py: the module's own run (8 ranks,
  REDUCED granite-3-8b, 4 steps on (2, 4), restored onto (1, 8) and
  (4, 2)) prints `elastic restart OK` with every drift under the
  reference's 5e-2.
* 2 ranks at f32: 2 steps on (1, 2), a checkpoint, 1 step on (2, 1)
  after the restore; the 3 losses equal the port's unmeshed run within
  1e-5 (the unmeshed run is held to the reference by
  tests/test_torch_train_parity.py), and the continuation on (1, 2)
  equals the one on (2, 1) within the same band.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import REDUCED
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import elastic
from repro_torch.models import init_params
from repro_torch.train import (DataConfig, HParams, adamw_init, make_batch,
                               make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 100}
SHAPE = ("t", 32, 4, "train")


def test_elastic_entry_point_restarts_on_every_mesh():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.elastic"],
                       env=dict(os.environ, PYTHONPATH="src"), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "elastic restart OK" in r.stdout
    drifts = [float(line.rsplit("mesh ", 1)[1].rstrip(")"))
              for line in r.stdout.splitlines() if "drift vs" in line]
    assert len(drifts) == 2 and all(d < elastic.DRIFT for d in drifts)


def _unmeshed_losses(cfg, steps):
    hp, shape = HParams(**HP), ShapeConfig(*SHAPE)
    params = init_params(0, cfg, "cpu")
    opt = adamw_init(params, cfg)
    step = make_train_step(cfg, hp)
    out = []
    for s in range(steps):
        params, opt, m = step(params, opt, make_batch(cfg, shape, s,
                                                      DataConfig(), "cpu"))
        out.append(float(m["loss"]))
    return out


def test_two_rank_f32_matches_the_unmeshed_run(tmp_path):
    job = {"arch": "granite-3-8b", "dtype": "float32", "first": (1, 2),
           "pre_steps": 2, "later": [(2, 1)], "post_steps": 1,
           "ckpt": str(tmp_path / "ckpt"), "out": str(tmp_path / "l.json"),
           "hp": HP, "shape": SHAPE}
    out = elastic.spawn(job, 2)
    want = _unmeshed_losses(dataclasses.replace(REDUCED["granite-3-8b"],
                                                dtype="float32"), 3)
    got = out["pre"] + out[str((2, 1))]
    assert got == pytest.approx(want, abs=1e-5, rel=0)
    assert out[str((1, 2))] == pytest.approx(out[str((2, 1))], abs=1e-5,
                                             rel=0)
