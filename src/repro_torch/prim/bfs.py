"""BFS — breadth-first search (graph processing, uint64 bitmaps). Table I:
sequential + random, bitwise logic, barrier+mutex, inter-DPU communication.

Level-synchronous frontier BFS: vertices (and their out-edges) are sharded
across banks; each level is one bank-local expand (OR into a
next-frontier bitmap) followed by a cross-bank OR exchange of the bitmap —
the paper's worst-case inter-DPU pattern (the whole frontier crosses the
host every level). Plain torch, as the reference computes it with jnp; a
bank's expand reads its own slice of the frontier (the reference slices
the replicated frontier by its bank index)."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from .common import randint

SUITABLE = False   # inter-DPU heavy (Takeaway 3)
REF_N = 2**18      # paper-scale graphs (loc-gowalla etc are ~200K vertices)

MAX_DEG = 8
UNSEEN = torch.iinfo(torch.int32).max


def make_inputs(n: int, gen, device=None):
    """Random graph: n vertices, MAX_DEG out-edges each (self-loops ok)."""
    adj = randint(gen, 0, n, (n, MAX_DEG), device)
    return {"adj": adj, "src": torch.zeros((), dtype=torch.int32,
                                           device=adj.device)}


def _start(n, src, device):
    dist = torch.full((n,), UNSEEN, dtype=torch.int32, device=device)
    dist[src.long()] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=device)
    frontier[src.long()] = True
    return dist, frontier


def ref(adj, src):
    n = adj.shape[0]
    dist, frontier = _start(n, src, adj.device)
    visited = frontier.clone()
    level = 0
    while bool(frontier.any()):
        level += 1
        nxt = torch.zeros(n, dtype=torch.bool, device=adj.device)
        nxt[adj[frontier].reshape(-1).long()] = True
        nxt &= ~visited
        dist = torch.where(nxt, level, dist)
        visited |= nxt
        frontier = nxt
    return dist


def run_pim(grid: BankGrid, adj, src):
    n = adj.shape[0]
    dist, frontier = _start(n, src, adj.device)
    visited = frontier.clone()
    level = 0

    # bank-local expand over the bank's adjacency rows, every bank at once:
    # (banks, rows, MAX_DEG) targets of the bank's frontier rows, n (one
    # slot past the end) for the others
    def expand(adj_b, mine):
        targets = torch.where(mine[..., None], adj_b.long(), n)
        nxt = torch.zeros(grid.n_banks, n + 1, dtype=torch.uint8,
                          device=adj_b.device)
        nxt.scatter_(1, targets.reshape(grid.n_banks, -1), 1)
        return nxt[:, None, :n]
    local_expand = grid.local(expand, in_specs=(BANKS, BANKS),
                              out_specs=BANKS, batched=True)

    while bool(frontier.any()):
        level += 1
        partial = local_expand(adj, frontier)      # (B, n) per-bank
        # exchange: cross-bank OR of the frontier bitmap (through the host)
        nxt = grid.exchange_reduce(partial, op="max")[0].bool()
        nxt &= ~visited
        dist = torch.where(nxt, level, dist)
        visited |= nxt
        frontier = nxt
    return dist


def counts(n: int) -> WorkloadCounts:
    e = n * MAX_DEG
    levels = 4.0   # random MAX_DEG-regular graphs have tiny diameter
    return WorkloadCounts(
        name="BFS",
        ops={("bitwise", "int64"): float(e + 2 * n * levels)},
        bytes_streamed=4.0 * e + (n / 8) * levels * 4,
        interbank_bytes=(n / 8) * levels * 64,   # bitmap x banks per level
        flops_equiv=float(e),
        pim_suitable=SUITABLE,
        bytes_cpu=64.0 * e,      # random vertex touch: line per edge
        bytes_gpu=32.0 * e / 4,  # sectors + warp coalescing over frontier
    )
