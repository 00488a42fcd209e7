"""Every token generated in the window (first tokens of admissions and
decode-step tokens), over the window's seconds."""


def read(run):
    t0, t1 = run.window["t0"], run.window["t1"]
    n = sum(1 for r in run.served for t in r.token_times if t0 <= t <= t1)
    return n / run.window["seconds"] if n else None
