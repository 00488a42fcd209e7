"""NW — Needleman-Wunsch global sequence alignment (bioinformatics, int32).
Table I: sequential + strided, add/sub/compare, barrier, inter-DPU
communication. The paper's canonical BAD-fit workload: every wavefront step
moves block boundaries between DPUs through the host.

Bank-parallel block-wavefront (the PrIM 2-D blocking):
  * columns are partitioned across banks (w = n/B each); rows are processed
    in blocks of height h = w (R = B row-blocks),
  * at wavefront step t, bank b computes row-block r = t - b: a (h, w) DP
    block, given its own previous top row (bank-local carry) and the left
    boundary column received from bank b-1 (exchange_shift per step),
  * the within-row dependence H[i][j] = max(c[j], H[i][j-1] - gap) is
    solved with the max-plus cummax transform
        H[i][p] = cummax(c[p] + gap*p) - gap*p
    so a whole row is one vectorized pass: a Python loop over the block's
    rows with `torch.cummax`, every bank's block in the same pass (the
    reference's `lax.scan` over rows, per bank).

Scoring: match +1, mismatch -1, linear gap -2 (vs the plain oracle)."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from .common import randint

SUITABLE = False   # inter-DPU per wavefront step (Takeaway 3)
REF_N = 2**12      # 4096 x 4096 DP matrix

MATCH, MISMATCH, GAP = 1, -1, 2


def make_inputs(n: int, gen, device=None):
    return {"a": randint(gen, 0, 4, (n,), device),
            "b": randint(gen, 0, 4, (n,), device)}


def ref(a, b):
    """The full DP, cell by cell on the host; returns the last row
    H[n][1..n] as int32 on a's device."""
    al, bl = a.tolist(), b.tolist()
    n, m = len(al), len(bl)
    prev = [-GAP * j for j in range(m + 1)]
    for i in range(1, n + 1):
        row = [-GAP * i] + [0] * m
        ai = al[i - 1]
        for j in range(1, m + 1):
            s = MATCH if bl[j - 1] == ai else MISMATCH
            row[j] = max(prev[j - 1] + s, prev[j] - GAP, row[j - 1] - GAP)
        prev = row
    return torch.tensor(prev[1:], dtype=torch.int32, device=a.device)


def _blocks(a_rows, b_loc, top, left_col, corner):
    """Solve every bank's (h, w) DP block at once. a_rows (B, h), b_loc
    (B, w), top (B, w), left_col (B, h), corner (B,). Returns (new_top
    (B, w), right_col (B, h))."""
    h, w = a_rows.shape[1], b_loc.shape[1]
    gaps = GAP * torch.arange(w + 1, dtype=torch.int32, device=b_loc.device)
    prev_row, prev_left = top, corner        # H[i-1][cols], H[i-1][c0]
    right = []
    for i in range(h):
        left_val = left_col[:, i]            # H[i][c0]
        diag = torch.cat([prev_left[:, None], prev_row[:, :-1]], 1)
        s = torch.where(b_loc == a_rows[:, i:i + 1], MATCH,
                        MISMATCH).to(b_loc.dtype)
        c = torch.maximum(diag + s, prev_row - GAP)
        e = torch.cat([left_val[:, None], c], 1) + gaps
        prev_row = (torch.cummax(e, 1).values - gaps)[:, 1:]
        prev_left = left_val
        right.append(prev_row[:, -1])
    return prev_row, torch.stack(right, 1)


def run_pim(grid: BankGrid, a, b):
    """Returns the final DP row H[n][1..n] (bank-sharded concatenation).
    Blocks are square: h = w = n / B."""
    n = int(a.shape[0])
    nb = grid.n_banks
    if n % nb:
        raise ValueError(f"NW: n={n} must divide by {nb} banks")
    h = n // nb
    r_blocks = nb
    dev = a.device
    banks = torch.arange(nb, device=dev)
    rows = torch.arange(h, dtype=torch.int32, device=dev)

    top = -GAP * (torch.arange(n, dtype=torch.int32, device=dev) + 1)
    msg = torch.zeros(nb, h + 1, dtype=torch.int32, device=dev)

    def step_fn(t, a_all, b_loc, top_loc, msg_in):
        # every bank at once: b_loc, top_loc (B, w); msg_in (B, 1, h + 1)
        r_idx = t - banks
        active = (r_idx >= 0) & (r_idx < r_blocks)
        row0 = r_idx.clamp(0, r_blocks - 1).to(torch.int32) * h
        # left boundary: bank 0 uses the DP edge, others the neighbor msg
        bound_left = -GAP * (row0[:, None] + 1 + rows)
        left_col = torch.where(banks[:, None] == 0, bound_left,
                               msg_in[:, 0, :h])
        corner = torch.where(banks == 0, -GAP * row0, msg_in[:, 0, h])
        a_rows = a_all[row0[:, None].long() + rows.long()]
        send_corner = top_loc[:, -1]          # H[row0][my last col]
        new_top, right_col = _blocks(a_rows, b_loc, top_loc, left_col,
                                     corner)
        top_out = torch.where(active[:, None], new_top, top_loc)
        msg_out = torch.cat([right_col, send_corner[:, None]], 1)[:, None]
        return top_out, msg_out

    for t in range(nb + r_blocks - 1):
        msg_in = grid.exchange_shift(msg, offset=1)   # host handshake
        top, msg = grid.local(
            lambda *args, _t=t: step_fn(_t, *args),
            in_specs=(None, BANKS, BANKS, BANKS), out_specs=(BANKS, BANKS),
            batched=True)(a, b, top, msg_in)
    return top


def counts(n: int) -> WorkloadCounts:
    cells = float(n * n)
    return WorkloadCounts(
        name="NW",
        ops={("add", "int32"): 2 * cells, ("sub", "int32"): 2 * cells,
             ("compare", "int32"): 3 * cells},
        bytes_streamed=4.0 * 2 * cells,
        interbank_bytes=8.0 * 64 * n,   # block boundaries, every wavefront
        flops_equiv=4.0 * cells,
        pim_suitable=SUITABLE,
    )
