"""Mean milliseconds that an admission spends issuing its work:
`ServeEngine.admit` from its start until the one-slot cache, the forward
and the copy into the batched cache are enqueued, the `launch_s` of the
window's `prefill_step` events.

The events are read from the program (`repro_torch.serve.engine.RECENT`,
its times on the host clock through `RECENT.origin`), because the run's
record (`bench.run.Run`) carries nothing of them; a program without that
trace reports nothing. Only events that began and ended inside the window
count, and none that overlaps the traced slice, whose profiler slows the
steps it holds."""


def read(run):
    try:
        from repro_torch.serve.engine import RECENT
    except ImportError:
        return None
    t0, t1 = run.window["t0"], run.window["t1"]
    s0, s1 = ((run.slice["t_start"], run.slice["t_end"])
              if run.slice is not None else (t1, t1))
    vals = []
    for e in list(RECENT.events):
        a, b = RECENT.origin + e.t0, RECENT.origin + e.t1
        if (e.kind == "prefill_step" and t0 <= a and b <= t1
                and not (a < s1 and b > s0)):
            vals.append(e.attrs["launch_s"])
    return 1e3 * sum(vals) / len(vals) if vals else None
