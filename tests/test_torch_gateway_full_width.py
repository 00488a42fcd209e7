"""gateway_bench's full-width serving workload (`full_width_gateway`,
section 1 of `repro_torch.benchmarks.gateway_bench` on the card and
chip_smoke.py's phase 15 (a)) at REDUCED width on the CPU."""

import dataclasses

import pytest

from repro_torch.benchmarks import gateway_bench as gb
from repro_torch.serve import poisson_requests

LENS = (8, 16)


@pytest.fixture(scope="module")
def run():
    """The workload built, its arrivals as built (`Gateway.run` rebases
    them onto its clock), and its run's stats."""
    fw = gb.full_width_gateway("cpu", reduced=True, max_len=64,
                               prompt_lens=LENS, pos_bucket=64)
    built = [(g.arrival_s, len(g.prompt), g.max_new_tokens)
             for g in fw.requests]
    return fw, built, fw.gateway.run(fw.requests)


def test_rate_is_the_load_share_of_the_measured_engine(run):
    fw, _, _ = run
    assert fw.sustain_rps == pytest.approx(
        gb.FULL_SLOTS / (fw.admission_s + (gb.FULL_NEW - 1) * fw.step_s),
        rel=1e-12)
    assert fw.rate_rps == pytest.approx(gb.FULL_LOAD * fw.sustain_rps,
                                        rel=1e-12)
    assert (fw.gateway.slo_ttft_s, fw.gateway.slo_itl_s) == \
        (gb.FULL_SLO_TTFT_S, gb.FULL_SLO_ITL_S)


def test_arrivals_round_trip_the_trace_file(run):
    """The requests read back from the trace file are `poisson_requests`'s
    draw for draw, each prompt at the length its drawn index names."""
    fw, built, _ = run
    shape = poisson_requests(gb.FULL_REQUESTS, fw.rate_rps, seed=gb.SEED,
                             prompt_lens=(1, len(LENS)),
                             max_new=(gb.FULL_NEW, gb.FULL_NEW),
                             priorities=(1,), weights=(1,))
    assert built == \
        [(g.arrival_s, LENS[len(g.prompt) - 1], gb.FULL_NEW) for g in shape]


def test_prewarm_covers_the_envelope_and_the_run_passes_its_gates(run):
    fw, _, stats = run
    assert fw.prewarm["misses"] == gb.FULL_SLOTS * 1 + len(LENS)
    assert fw.prewarm["evictions"] == 0
    gb.check_full_width(fw, stats)
    assert stats.completed == gb.FULL_REQUESTS
    assert stats.tokens == gb.FULL_REQUESTS * gb.FULL_NEW


def test_check_refuses_a_plan_solved_in_band(run):
    fw, _, stats = run
    solved = dict(stats.plan_cache, misses=stats.plan_cache["misses"] + 1)
    with pytest.raises(AssertionError, match="in band"):
        gb.check_full_width(fw, dataclasses.replace(stats,
                                                    plan_cache=solved))
