"""The comparison that decides `correct` for a served model.

Once the window has closed, a sample of the requests the program
finished, drawn from the seed and holding the longest of them, is run
through the plain reference: each prompt with its served tokens, in one
causal pass. Each served token has a gap: how far its reference logit
lies below the reference's best at that position (greedy serving: 0
where the program and the reference agree). A cell's file holds one or
more numbers of the gaps to limits (`NUMBERS`): the widest gap, or the
share of gaps over 1 (logits here have an RMS of about 1). The control reads, at the same positions, the gaps of the
tokens that the reference computed in float8 puts first.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch


def sample(done: list, seed: int, requests: int) -> list:
    """`requests` of the finished requests to compare: the longest
    (prompt plus served tokens), and others drawn from the seed."""
    if not done:
        return []
    by_len = sorted(done, key=lambda r: (r.prefilled + len(r.served), r.rid))
    rest = by_len[:-1]
    order = np.random.Generator(np.random.PCG64([int(seed), 2])).permutation(
        len(rest))
    return [by_len[-1]] + [rest[i] for i in order[:requests - 1]]


def reference_module(c: dict):
    """The plain reference that configuration file `c` names."""
    return importlib.import_module(f"bench.reference.{c['reference']}")


def _inputs(reqs, device):
    seqs, starts, prefilled, served = [], [], [], []
    for r in reqs:
        toks = np.concatenate([r.prompt, np.asarray(r.served[:-1],
                                                     dtype=np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        starts.append(r.prefilled - 1)
        prefilled.append(r.prefilled)
        served.append(torch.as_tensor(r.served, device=device))
    return seqs, prefilled, starts, served


def gaps(c: dict, weights: dict, reqs, precision: str = "f32"):
    """(the gap of every served token below the reference's best at its
    position, seconds). With `precision="fp8"` the reference itself in
    float8 stands in for the program: the gap of its own top token
    against the float32 reference, the control."""
    ref = reference_module(c)
    t0 = time.perf_counter()
    seqs, prefilled, starts, served = _inputs(reqs, weights["embed"].device)
    want = ref.logits_at(c, weights, seqs, prefilled, starts)
    if precision != "f32":
        low = ref.logits_at(c, weights, seqs, prefilled, starts, precision)
        served = [lg.argmax(-1) for lg in low]
        del low
    out = [lg.max(-1).values - lg.gather(-1, tok[:, None].long())[:, 0]
           for lg, tok in zip(want, served)]
    return torch.cat(out).float().cpu(), time.perf_counter() - t0


#: the numbers a cell's file may hold to a limit, each from the gap vector:
#: the widest gap, and the share of served tokens more than 1 below the
#: reference's best (steady where top-k routing makes the widest gap
#: swing, and still raised by a fault in part of the batch: PERF.md)
NUMBERS = {
    "logit_gap": lambda g: float(g.max()),
    "share_over_1": lambda g: float((g > 1.0).float().mean()),
}


def summary(g) -> dict:
    """Quantiles of a gap vector and the share of exact agreement."""
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99]))
    return {"widest": float(g.max()), "p99": float(q[2]),
            "p90": float(q[1]), "median": float(q[0]),
            "mean": float(g.mean()), "agree": float((g == 0).float().mean()),
            "n": int(g.numel())}
