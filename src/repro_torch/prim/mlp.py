"""MLP — multilayer perceptron inference (neural networks, int32).
Table I: sequential, add+mul+compare (ReLU), no intra-DPU sync, but each
layer boundary is an inter-DPU exchange: the layer output must be gathered
and re-broadcast because the next layer's GEMV needs the WHOLE vector on
every bank (weights are row-partitioned, Takeaway 3's cost made visible).

Port: each layer's bank-local GEMV is one launch of the gemv kernel's
int32 route over every bank's rows, ReLU a plain clamp."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from ..kernels import ops
from .common import randint

SUITABLE = False   # multiplication (Takeaway 2)
REF_N = 2**12      # 3 square layers of width 4096

N_LAYERS = 3


def make_inputs(n: int, gen, device=None):
    """n = layer width; N_LAYERS square layers."""
    ws = [randint(gen, -4, 5, (n, n), device) for _ in range(N_LAYERS)]
    return {"ws": ws, "x": randint(gen, -4, 5, (n,), device)}


def ref(ws, x):
    """ReLU(W h) per layer in int32, wrapping: int64 products and sums cut
    to 32 bits."""
    h = x
    for w in ws:
        h = (w.long() * h.long()).sum(1).to(torch.int32).clamp_min(0)
    return h


def run_pim(grid: BankGrid, ws, x):
    def layer(wb, hb):
        y = ops.gemv(wb.reshape(-1, wb.shape[-1]), hb, acc=torch.int32)
        return y.clamp_min(0).view(wb.shape[:2])
    local_gemv = grid.local(layer, in_specs=(BANKS, None), out_specs=BANKS,
                            batched=True)
    h = x
    for w in ws:
        part = local_gemv(w, h)         # bank-local GEMV on the row block
        h = grid.exchange_gather(part)  # layer boundary: through the host
    return h


def counts(n: int) -> WorkloadCounts:
    ops_mm = float(N_LAYERS * n * n)
    return WorkloadCounts(
        name="MLP",
        ops={("mul", "int32"): ops_mm, ("add", "int32"): ops_mm,
             ("compare", "int32"): float(N_LAYERS * n)},
        bytes_streamed=4.0 * (N_LAYERS * n * n + 2 * N_LAYERS * n),
        interbank_bytes=4.0 * N_LAYERS * n,   # gather+rebroadcast per layer
        flops_equiv=2.0 * ops_mm,
        pim_suitable=SUITABLE,
    )
