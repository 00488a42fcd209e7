"""% of the window's batched decode steps that a CUDA graph replayed: the
`graphed` flag of the window's `decode_step` events.

The events are read from the program (`repro_torch.serve.engine.RECENT`,
its times on the host clock through `RECENT.origin`), because the run's
record (`bench.run.Run`) carries nothing of them; a program without that
trace, or whose steps carry no such flag, reports nothing. Only events
that began and ended inside the window count, and none that overlaps the
traced slice, as `engine.launch_ms.decode` reads them."""


def read(run):
    try:
        from repro_torch.serve.engine import RECENT
    except ImportError:
        return None
    t0, t1 = run.window["t0"], run.window["t1"]
    s0, s1 = ((run.slice["t_start"], run.slice["t_end"])
              if run.slice is not None else (t1, t1))
    flags = []
    for e in list(RECENT.events):
        a, b = RECENT.origin + e.t0, RECENT.origin + e.t1
        if (e.kind == "decode_step" and "graphed" in e.attrs
                and t0 <= a and b <= t1 and not (a < s1 and b > s0)):
            flags.append(bool(e.attrs["graphed"]))
    return 100.0 * sum(flags) / len(flags) if flags else None
