"""Mean milliseconds of an admission (`ServeEngine.admit`: the one-slot
prefill and its first token, to the engine's host sync), from the
engine's counters `prefill_s` and `n_prefills` over the window."""


def read(run):
    n = run.engine["n_prefills"]
    return 1e3 * run.engine["prefill_s"] / n if n else None
