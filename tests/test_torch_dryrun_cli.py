"""The twin of tests/test_dryrun.py on the port: `python -m
repro_torch.launch.dryrun` for whisper-tiny, decode_32k and train_4k on
both production meshes, in a subprocess (its fake process group is
process-wide): 4 `ok` records, positive terms, 256 and 512 chips, decode
memory-dominant, and the train step's collectives; then the
`roofline_bench` twin renders the records' table (and, with no records,
says how to make them)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_twin_of_the_reference_test(tmp_path, monkeypatch, capsys):
    out = tmp_path / "runs" / "dryrun_single.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "whisper-tiny", "--shape", "decode_32k,train_4k",
         "--mesh", "both", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH="src"), capture_output=True,
        text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    recs = json.load(open(out))
    assert len(recs) == 4                      # 2 shapes x 2 meshes
    for rec in recs:
        assert rec["status"] == "ok", rec
        rf = rec["roofline"]
        assert rf["memory_s"] > 0
        assert rf["compute_s"] >= 0
        assert rf["dominant"] in ("compute", "memory", "collective")
        assert 0 <= rf["roofline_fraction"] <= 1
    assert {rec["n_chips"] for rec in recs} == {256, 512}
    dec = [rec for rec in recs if rec["shape"] == "decode_32k"]
    assert all(rec["roofline"]["dominant"] == "memory" for rec in dec)
    train = [rec for rec in recs if rec["shape"] == "train_4k"]
    assert all(rec["collective_bytes_per_device"] > 0 for rec in train)

    from repro_torch.benchmarks import run as bench_run
    monkeypatch.chdir(tmp_path)
    assert bench_run.main(["roofline_bench", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "Roofline (single-pod 16x16), from runs/dryrun_single.json" in text
    assert "| whisper-tiny/decode_32k | memory |" in text
    assert "4 traced cells, 0 documented skips" in text
    monkeypatch.chdir(tmp_path / "runs")
    assert bench_run.main(["roofline_bench", "--device", "cpu"]) == 0
    assert "no dry-run artifacts under runs/" in capsys.readouterr().out
