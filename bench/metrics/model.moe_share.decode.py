"""% of the decode steps' issuing time spent in the MoE layers: in the
traced slice, the seconds of the `model.moe` spans inside decode steps
over the seconds of the `engine.decode.launch` spans (the spans of
admissions, which carry a `rid` and no `step`, left out).

The spans are read from the program (`repro_torch.serve.engine.RECENT`,
its times on the host clock through `RECENT.origin`), because the run's
record (`bench.run.Run`) carries nothing of them; a program without that
trace, or whose models record no such span, reports nothing. The program
records spans only while the profiler runs, so only in the slice."""


def read(run):
    if run.slice is None:
        return None
    try:
        from repro_torch.serve.engine import RECENT
    except ImportError:
        return None
    s0, s1 = run.slice["t_start"], run.slice["t_end"]
    spent = {"model.moe": 0.0, "engine.decode.launch": 0.0}
    for e in list(RECENT.events):
        if (e.kind == "span" and e.name in spent and "step" in e.attrs
                and s0 <= RECENT.origin + e.t0
                and RECENT.origin + e.t1 <= s1):
            spent[e.name] += e.dur_s
    moe, launch = spent["model.moe"], spent["engine.decode.launch"]
    return 100.0 * moe / launch if moe > 0 and launch > 0 else None
