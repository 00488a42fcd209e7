"""The port's examples (`python -m repro_torch.examples.<name>`) on the
CPU at small arguments: each `main([..., "--device", "cpu"])` runs to its
end and what it prints or returns is right."""

import json

import pytest

from repro_torch.examples import (dispatch_demo, gateway_serve,
                                  prim_multibank, quickstart, serve_decode)


def test_quickstart(capsys):
    assert quickstart.main(["--n", "4096", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "SCAN-SSA on 1 bank(s) (cpu): correct=True" in out
    assert "PIM-suitable: True" in out and "(paper: 23.2x)" in out


def test_prim_multibank(capsys):
    assert prim_multibank.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "bank grid: 8 banks on cpu" in out
    assert out.count("correct=True") == 3


def test_dispatch_demo(capsys):
    rep = dispatch_demo.main(["--m", "64", "--model-m", "1024",
                              "--device", "cpu"])
    assert rep.matches and rep.max_abs_err == 0.0
    assert set(rep.stage_devices.values()) == {"xeon", "upmem_2556"}
    assert "== modeled at 1024x1024 int32 ==" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["jit", "dispatch"])
def test_serve_decode(engine, tmp_path, capsys):
    args = ["--requests", "3", "--max-new", "4", "--device", "cpu",
            "--engine", engine]
    if engine == "dispatch":
        args += ["--prefill-chunk", "4", "--show-schedule", "--trace",
                 str(tmp_path / "t.json")]
    done = serve_decode.main(args)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 4 for r in done)
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    if engine == "dispatch":
        assert "decode plan [dag-dp" in out and "executed timeline" in out
        doc = json.loads((tmp_path / "t.json").read_text())
        assert any(e["kind"] == "decode_step" for e in doc["events"])
        assert "ms launch + " in out


@pytest.mark.parametrize("engine", ["jit", "dispatch"])
def test_gateway_serve(engine, tmp_path, capsys):
    args = ["--requests", "4", "--device", "cpu", "--engine", engine,
            "--trace", str(tmp_path / "g.json")]
    if engine == "jit":
        args.append("--prewarm")
    else:
        args += ["--prefill-chunk", "4"]
    stats = gateway_serve.main(args)
    assert stats.offered == 4 and stats.completed + stats.rejected == 4
    assert stats.completed > 0 and stats.tokens > 0
    out = capsys.readouterr().out
    assert "plan-cache hit rate" in out
    assert (tmp_path / "g.chrome.json").exists()
