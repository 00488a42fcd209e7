"""The port's training substrate (`repro_torch.train`) on the CPU: the
twins of tests/test_train.py on REDUCED starcoder2-7b (schedule, clip,
AdamW on a quadratic, checkpoint round trip, atomicity, structure
mismatch, bitwise restart, loss decreasing, stragglers), the schedule
against the reference's, checkpoints crossing between the packages bit
for bit in both directions, `launch.train` and `examples.train_lm`."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as jtrain
from repro_torch.configs import REDUCED
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.examples import train_lm
from repro_torch.launch import train as launch_train
from repro_torch.train import (DataConfig, HParams, InjectedFailure,
                               LoopConfig, TrainLoop, adamw_init,
                               adamw_update, clip_by_global_norm, global_norm,
                               latest_step, restore, save, schedule,
                               valid_steps)
from repro_torch.train.optimizer import leaves

CFG = REDUCED["starcoder2-7b"]
SHAPE = ShapeConfig("t", 32, 4, "train")
HP = HParams(lr=1e-3, warmup_steps=5, total_steps=50)


def test_schedule_shape():
    assert float(schedule(0, HP)) == 0.0
    assert float(schedule(5, HP)) == pytest.approx(HP.lr)
    assert float(schedule(50, HP)) == pytest.approx(HP.lr * HP.min_lr_frac)
    vals = [float(schedule(s, HP)) for s in range(5, 51, 5)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


def test_schedule_matches_reference():
    jhp = jtrain.HParams(lr=1e-3, warmup_steps=5, total_steps=50)
    for s in range(0, 56):
        assert float(schedule(torch.tensor(s, dtype=torch.int32), HP)) == \
            pytest.approx(float(jtrain.schedule(s, jhp)), rel=1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 3.0, "b": torch.ones(4) * 4.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_adamw_descends_quadratic():
    hp = dataclasses.replace(HP, lr=0.1, weight_decay=0.0,
                             warmup_steps=0, total_steps=1000)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params, CFG)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, hp, CFG)
    assert float(params["w"].abs().max()) < 0.3
    assert int(opt["step"]) == 200


def _tree():
    return {"a": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
            "b": {"c": torch.ones(2, dtype=torch.int32)},
            "l": [torch.full((2, 2), 0.5), torch.zeros(3, dtype=torch.float64)],
            "s": torch.zeros((), dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save(str(tmp_path), 7, tree)
    assert valid_steps(str(tmp_path)) == [7]
    back = restore(str(tmp_path), 7, tree)
    for a, b in zip(leaves(tree), leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_atomicity(tmp_path):
    """A step dir without manifest.json is invisible to restore."""
    save(str(tmp_path), 1, {"a": torch.ones(4)})
    os.makedirs(tmp_path / "step_2")
    with open(tmp_path / "step_2" / "leaf_0.bin", "wb") as f:
        f.write(b"partial")
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_structure_mismatch(tmp_path):
    save(str(tmp_path), 1, {"a": torch.ones(4)})
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, {"a": torch.ones(4), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), 1, {"a": torch.ones(5)})


def _jax_tree(tree):
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return {"a": conv(tree["a"]), "b": {"c": conv(tree["b"]["c"])},
            "l": [conv(t) for t in tree["l"]], "s": conv(tree["s"])}


def _same_bits(t, j):
    j = np.asarray(j)
    if t.dtype == torch.bfloat16:
        return np.array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
    return np.array_equal(t.numpy(), j) and t.numpy().dtype == j.dtype


def test_checkpoint_written_by_the_reference_restores_bit_exact(tmp_path):
    tree = _tree()
    tree["l"][1] = torch.tensor([1.5, -2.25, 3.0])     # f32: x64 is off
    jtree = _jax_tree(tree)
    jtrain.save(str(tmp_path), 3, jtree)
    assert valid_steps(str(tmp_path)) == [3]
    like = {**tree, "l": [tree["l"][0], tree["l"][1].float()]}
    back = restore(str(tmp_path), 3, like)
    for t, j in zip(leaves(back), jax.tree.leaves(jtree)):
        assert _same_bits(t, j)


def test_checkpoint_written_by_the_port_restores_bit_exact(tmp_path):
    tree = _tree()
    tree["l"][1] = torch.tensor([1.5, -2.25, 3.0])
    save(str(tmp_path), 4, tree)
    assert jtrain.latest_step(str(tmp_path)) == 4
    back = jtrain.restore(str(tmp_path), 4, _jax_tree(tree))
    for t, j in zip(leaves(tree), jax.tree.leaves(back)):
        assert _same_bits(t, j)


def _loop(ckpt, fail, total=12):
    return TrainLoop(CFG, SHAPE, HP,
                     LoopConfig(total_steps=total, ckpt_every=5,
                                ckpt_dir=ckpt, log_every=100,
                                fail_at_step=fail), device="cpu")


def test_restart_is_bitwise_exact(tmp_path):
    """Crash at step 8, resume from the step-5 checkpoint, end bitwise
    equal to an uninterrupted run (data pipeline is pure in step)."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ref_loop = _loop(d1, None)
    ref_state = ref_loop.run(ref_loop.resume_or_init())

    crash_loop = _loop(d2, 8)
    with pytest.raises(InjectedFailure):
        crash_loop.run(crash_loop.resume_or_init())
    resume_loop = _loop(d2, None)
    state = resume_loop.resume_or_init()
    assert state.step == 5
    state = resume_loop.run(state)

    for a, b in zip(leaves({"p": ref_state.params, "o": ref_state.opt}),
                    leaves({"p": state.params, "o": state.opt})):
        assert torch.equal(a, b)


def test_loss_decreases(tmp_path):
    loop = TrainLoop(CFG, SHAPE, HParams(lr=3e-3, warmup_steps=5,
                                         total_steps=60),
                     LoopConfig(total_steps=40, ckpt_every=1000,
                                ckpt_dir=str(tmp_path), log_every=1),
                     device="cpu")
    loop.run(loop.init_state())
    losses = [m["loss"] for m in loop.metrics_log]
    assert np.mean(losses[-5:]) < losses[0] - 0.2, losses[:3] + losses[-3:]


def test_straggler_detection(tmp_path):
    loop = TrainLoop(CFG, SHAPE, HP,
                     LoopConfig(total_steps=1, ckpt_every=1000,
                                ckpt_dir=str(tmp_path)), device="cpu")
    for i in range(20):
        loop._check_straggler(i, 0.1)
    loop._check_straggler(20, 1.0)
    assert loop.straggler_steps == [20]


def test_data_is_a_pure_function_of_seed_and_step():
    from repro_torch.train import make_batch
    cfg = REDUCED["qwen2-vl-72b"]
    a = make_batch(cfg, SHAPE, 3, DataConfig(seed=5), "cpu")
    b = make_batch(cfg, SHAPE, 3, DataConfig(seed=5), "cpu")
    c = make_batch(cfg, SHAPE, 4, DataConfig(seed=5), "cpu")
    assert set(a) == {"embeds", "mrope_positions", "labels"}
    assert a["mrope_positions"].shape == (3, 4, 32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["labels"], c["labels"])
    w = make_batch(REDUCED["whisper-tiny"], SHAPE, 0, DataConfig(), "cpu")
    assert set(w) == {"tokens", "labels", "encoder_embeds"}
    assert w["tokens"].dtype == torch.int32
    assert w["encoder_embeds"].dtype == torch.bfloat16
    assert int(w["tokens"].max()) < REDUCED["whisper-tiny"].vocab_size


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "granite-3-8b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    assert launch_train.main(argv + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "done: 4 steps" in out and "resumed" not in out
    logged = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    assert all(np.isfinite(m["loss"]) for m in logged)
    assert valid_steps(str(tmp_path)) == [2, 4]
    assert launch_train.main(argv + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 6 steps" in out


def test_launch_train_mesh_matches_the_unmeshed_run(tmp_path):
    """`--mesh` trains on a (1, 1) gloo mesh (a one-process group started
    and ended by the launcher, in a subprocess): every logged loss, grad
    norm and learning rate bit-equal to the run without it."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    logs = []
    for extra in ([], ["--mesh"]):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "granite-3-8b", "--reduced", "--device", "cpu", "--batch", "2",
             "--seq", "16", "--steps", "3", "--log-every", "1",
             "--ckpt-dir", str(tmp_path / f"c{len(extra)}")] + extra,
            env=dict(os.environ, PYTHONPATH="src"), cwd=root,
            capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        logs.append([json.loads(l) for l in r.stdout.splitlines()
                     if l.startswith("{")])
    assert len(logs[0]) == 3 and logs[0] == logs[1]


def test_example_train_lm_runs(tmp_path, capsys):
    assert train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "done: 2 steps" in out and "loss:" in out
