"""The port's Fig. 2/3 microbenchmark entry point and the modelled machines
it reads, against the reference's `benchmarks/microbench.py` and
`repro.core.pim_model`. Both compute the same model arithmetic, so the
tables must be equal, not close."""

import dataclasses

import pytest
import torch

import benchmarks.microbench as jmb
from repro.core import pim_model as jpm
from repro_torch.benchmarks import microbench as tmb
from repro_torch.benchmarks import run as trun
from repro_torch.core import pim_model as tpm

MACHINE_NAMES = ["TPU_V5E", "XEON_E3_1240", "TITAN_V"]
DPU_NAMES = ["UPMEM_2556", "UPMEM_640"]


@pytest.mark.parametrize("name", MACHINE_NAMES + DPU_NAMES)
def test_pim_model_machines_equal_field_for_field(name):
    want, got = getattr(jpm, name), getattr(tpm, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name in DPU_NAMES:
        assert dataclasses.asdict(got.as_machine()) == \
            dataclasses.asdict(want.as_machine())
        assert got.aggregate_mram_bw == want.aggregate_mram_bw
    else:
        assert got.balance == want.balance


def test_pim_model_tables_equal():
    assert tpm.DPU_OP_COST == jpm.DPU_OP_COST
    assert tpm.DPU_LOOP_OVERHEAD == jpm.DPU_LOOP_OVERHEAD
    assert {k: dataclasses.asdict(v) for k, v in tpm.MACHINES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jpm.MACHINES.items()}
    want, got = jpm.UPMEM_2556, tpm.UPMEM_2556
    counts = {("add", "int32"): 1e6, ("mul", "float"): 3e5}
    assert got.compute_time(counts) == want.compute_time(counts)
    assert got.mram_time(1 << 20) == want.mram_time(1 << 20)
    assert got.interdpu_time(1 << 20) == want.interdpu_time(1 << 20)
    for op, dt in [("add", "int32"), ("div", "double"), ("nope", "int8")]:
        assert got.op_throughput(op, dt, 3.0) == \
            want.op_throughput(op, dt, 3.0)


def test_fig2_rows_equal_reference():
    assert tmb.fig2_rows() == jmb.fig2_rows()


def test_fig3_rows_equal_reference():
    assert tmb.fig3_rows() == jmb.fig3_rows()


def test_run_on_cpu_passes_its_assertions(capsys):
    tmb.run(trun.Report(), device="cpu")
    out = capsys.readouterr().out
    assert "plain PyTorch version on cpu" in out
    assert out.count("| True |") == len(tmb.SWEEP_K)


def test_cli_microbench_on_cpu(capsys):
    assert trun.main(["microbench", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "1/1 benchmark modules ok" in out
    assert "Fig. 3" in out


def test_cli_rejects_unknown_module():
    with pytest.raises(SystemExit):
        trun.main(["no_such_bench", "--device", "cpu"])


def test_entry_points_need_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["microbench"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmb.run(trun.Report())
