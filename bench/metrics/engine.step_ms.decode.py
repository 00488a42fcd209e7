"""Mean milliseconds of a batched decode step (`ServeEngine.step`, to its
one host sync), from the engine's counters `decode_s` and
`n_decode_steps` over the window."""


def read(run):
    n = run.engine["n_decode_steps"]
    return 1e3 * run.engine["decode_s"] / n if n else None
