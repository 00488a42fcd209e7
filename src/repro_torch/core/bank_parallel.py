"""Bank-parallel execution: the UPMEM programming model on one card.

UPMEM programs are structured as (paper §I, Fig. 1):

    host scatter -> [bank-local kernel on each DPU's MRAM shard]
                 -> host-mediated exchange (there is NO DPU<->DPU channel)
                 -> [bank-local kernel] -> ... -> host gather

The port's twin of `repro.core.bank_parallel`. The reference makes a bank
one device of a mesh axis and runs a local phase under `shard_map`; here
`n_banks` virtual banks live on one device, and a bank's MRAM is its
contiguous split of an array's leading axis (the split `shard_map` makes,
so the leading axis must divide by the bank count). Every inter-bank
exchange is an explicit tensor step between phases, with the semantics of
the reference's collective. The discipline "no communication inside a
local phase" is checked by `assert_local`, which traces the phase with
torch.fx and refuses a trace that holds an exchange or a
`torch.distributed` collective (Takeaway 3).

A local phase runs its body in one of two ways:

  * per bank (the default): once on each bank's shard, as `shard_map`
    runs it. A body whose kernel reduces over its shard (RED, SCAN, HST,
    TS) launches its kernel once per bank;
  * `batched=True`: once on the stacked shards, each sharded argument
    viewed as (n_banks, per-bank length, ...), returning stacked outputs.
    A body whose kernel is elementwise or row-wise (VA, GEMV, MLP, TRNS)
    is then one launch over every bank.

Replicated arguments and outputs (spec `None`, the reference's `P()`) are
passed and returned whole.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch

from ..device import resolve_device

BANKS = "banks"       # spec of an array split over the banks on dim 0

#: torch.distributed functions that cross processes; `assert_local`
#: refuses a phase that calls one
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_to_all", "all_to_all_single", "reduce_scatter",
               "reduce_scatter_tensor", "broadcast", "reduce", "gather",
               "scatter", "send", "recv", "isend", "irecv", "barrier")
EXCHANGES = ("exchange_reduce", "exchange_gather", "exchange_scan_sums",
             "exchange_shift", "exchange_all_to_all")


def _specs(specs, n: int) -> list:
    if isinstance(specs, (tuple, list)):
        if len(specs) != n:
            raise ValueError(f"{len(specs)} specs for {n} values")
        return list(specs)
    return [specs] * n


class BankGrid:
    """`n_banks` virtual banks on one device (None: the card)."""

    def __init__(self, n_banks: int = 1, device=None):
        if n_banks < 1:
            raise ValueError(f"n_banks must be >= 1, got {n_banks}")
        self.n_banks = int(n_banks)
        self.device = resolve_device(device)

    # ---------------------------------------------------------------
    # the banks' shards
    # ---------------------------------------------------------------
    def split(self, x: torch.Tensor) -> torch.Tensor:
        """x (n, ...) as (n_banks, n / n_banks, ...), a view where x is
        contiguous; n must divide by the bank count."""
        if x.dim() == 0 or x.shape[0] % self.n_banks:
            raise ValueError(f"leading axis of {tuple(x.shape)} does not "
                             f"split over {self.n_banks} banks")
        return x.reshape(self.n_banks, -1, *x.shape[1:])

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        """(n_banks, k, ...) -> (n_banks * k, ...): the banks' shards as one
        array, bank 0's first."""
        if x.dim() < 2 or x.shape[0] != self.n_banks:
            raise ValueError(f"want (n_banks={self.n_banks}, k, ...), got "
                             f"{tuple(x.shape)}")
        return x.reshape(-1, *x.shape[2:])

    # ---------------------------------------------------------------
    # local phases
    # ---------------------------------------------------------------
    def local(self, fn: Callable, in_specs=BANKS, out_specs=BANKS,
              batched: bool = False) -> Callable:
        """A bank-local phase: `fn` on every bank's shard. `in_specs` and
        `out_specs` are BANKS or None, one for all or one per argument and
        output (a tuple of specs: `fn` returns a tuple). A list of one host
        value per bank (`bank_ids`) with spec BANKS gives each bank its
        value (the whole list when batched). Every array must lie on the
        grid's device. Exchanges inside `fn` are a programming error
        (Takeaway 3); `assert_local` verifies."""
        def phase(*args):
            specs = _specs(in_specs, len(args))
            for a in args:
                if isinstance(a, torch.Tensor) and \
                        a.device.type != self.device.type:
                    raise ValueError(f"a {a.device} array in a phase of "
                                     f"banks on {self.device}")
            many = isinstance(out_specs, (tuple, list))
            if batched:
                outs = fn(*[self.split(a) if s == BANKS
                            and not self._is_host_list(a) else a
                            for a, s in zip(args, specs)])
                outs = outs if many else (outs,)
                res = [self.merge(o) if s == BANKS else o
                       for o, s in zip(outs, _specs(out_specs, len(outs)))]
                return tuple(res) if many else res[0]
            shards = [None if s != BANKS else a if self._is_host_list(a)
                      else self.split(a) for a, s in zip(args, specs)]
            per_bank = []
            for b in range(self.n_banks):
                out = fn(*[a if sh is None else sh[b]
                           for a, sh in zip(args, shards)])
                per_bank.append(out if many else (out,))
            res = []
            for i, s in enumerate(_specs(out_specs, len(per_bank[0]))):
                parts = [o[i] for o in per_bank]
                if s != BANKS or len(parts) == 1:
                    res.append(parts[0])
                else:
                    res.append(torch.cat(parts))
            return tuple(res) if many else res[0]
        return phase

    def _is_host_list(self, a) -> bool:
        """A list of one host value per bank, split like an array."""
        if not isinstance(a, (list, tuple)):
            return False
        if len(a) != self.n_banks:
            raise ValueError(f"{len(a)} host values for {self.n_banks} "
                             f"banks")
        return True

    def bank_ids(self) -> list[int]:
        """Each bank's index, as host values to split over the banks: a
        body given it (spec BANKS) reads its own index with no device sync
        (the reference's `axis_index`)."""
        return list(range(self.n_banks))

    def bank_map(self, fn: Callable, batched: bool = False) -> Callable:
        """Common case: every argument split over the banks, every output
        too."""
        return self.local(fn, BANKS, BANKS, batched)

    # ---------------------------------------------------------------
    # exchange phases (the "through the host" step on UPMEM): tensor
    # steps between the banks' shards, each bank's shard the split of
    # the leading axis
    # ---------------------------------------------------------------
    def exchange_reduce(self, x: torch.Tensor, op: str = "add"
                        ) -> torch.Tensor:
        """Every bank ends with the reduction (add, max, min) of all banks'
        shards, in x's dtype (int32 adds wrap)."""
        s = self.split(x)
        if op == "add":
            r = torch.sum(s, 0, dtype=s.dtype)
        elif op == "max":
            r = torch.amax(s, 0)
        elif op == "min":
            r = torch.amin(s, 0)
        else:
            raise ValueError(op)
        return self.merge(r.expand(self.n_banks, *r.shape))

    def exchange_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every bank receives the concatenation of all banks' shards: on
        one device, the array itself (replicated, spec None)."""
        self.split(x)
        return x

    def exchange_scan_sums(self, bank_vals: torch.Tensor) -> torch.Tensor:
        """Exclusive scan across banks of per-bank values (SCAN-SSA's host
        phase): bank i receives the sum of banks [0, i), in order, in the
        values' dtype (int32 wraps)."""
        s = self.split(bank_vals)
        out = torch.zeros_like(s)
        if self.n_banks > 1:
            out[1:] = torch.cumsum(s[:-1], 0, dtype=s.dtype)
        return self.merge(out)

    def exchange_shift(self, x: torch.Tensor, offset: int = 1
                       ) -> torch.Tensor:
        """Neighbour handshake (NW's wavefront halo, TS's lookahead halo,
        UNI's last element): bank i gets bank i - offset's shard; banks with
        no such neighbour get zeros."""
        s = self.split(x)
        out = torch.zeros_like(s)
        b = self.n_banks
        if 0 <= offset < b:
            out[offset:] = s[:b - offset]
        elif -b < offset < 0:
            out[:b + offset] = s[-offset:]
        return self.merge(out)

    def exchange_all_to_all(self, x: torch.Tensor, split_axis: int = 0
                            ) -> torch.Tensor:
        """Each bank cuts its shard into n_banks equal chunks along
        `split_axis` of the shard and sends chunk j to bank j, which
        concatenates what it receives along the shard's first axis in the
        senders' order (`jax.lax.all_to_all(..., tiled=True)`)."""
        s = self.split(x)
        b, d = self.n_banks, 1 + split_axis
        if not 1 <= d < s.dim() or s.shape[d] % b:
            raise ValueError(f"shards {tuple(s.shape[1:])} do not cut into "
                             f"{b} chunks along axis {split_axis}")
        s = s.reshape(*s.shape[:d], b, s.shape[d] // b, *s.shape[d + 1:])
        # (src, ..., dst, chunk, ...) -> (dst, src, ...), one bank's
        # received chunks in the senders' order
        perm = [d, *range(d), *range(d + 1, s.dim())]
        r = s.permute(perm).contiguous()
        return r.reshape(-1, *r.shape[3:])


# ---------------------------------------------------------------------
# Phase-discipline verification
# ---------------------------------------------------------------------

@functools.cache
def _marker():
    """The op an exchange or collective leaves in a census trace."""
    @torch.library.custom_op("repro_torch::bank_exchange", mutates_args=())
    def bank_exchange(x: torch.Tensor, name: str) -> torch.Tensor:
        return x.clone()
    return bank_exchange


@contextlib.contextmanager
def _marked_exchanges():
    """While tracing, every exchange of a BankGrid records a marker op on
    its first argument and then runs (a loop that reads an exchange's
    result on the host traces as it runs); every collective of
    torch.distributed records the marker in place of running."""
    mark = _marker()
    saved = []

    def marked(name, real=None):
        def call(*args, **kwargs):
            t = next((a for a in args if isinstance(a, torch.Tensor)),
                     torch.zeros(()))
            out = mark(t, name)
            return out if real is None else real(*args, **kwargs)
        return call

    for name in EXCHANGES:
        real = getattr(BankGrid, name)
        saved.append((BankGrid, name, real))
        setattr(BankGrid, name, lambda self, *a, _n=name, _r=real, **k:
                marked(_n, functools.partial(_r, self))(*a, **k))
    if torch.distributed.is_available():
        for name in COLLECTIVES:
            if hasattr(torch.distributed, name):
                saved.append((torch.distributed, name,
                              getattr(torch.distributed, name)))
                setattr(torch.distributed, name, marked(name))
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def census(fn: Callable, *example_args: Any) -> list[str]:
    """Trace fn on the example arguments with torch.fx (`make_fx`) and list
    the exchanges and collectives in the trace: [] for a legal bank-local
    phase."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with _marked_exchanges():
        # real tensors: a body may read values on the host (a count, a
        # frontier's emptiness), as the reference's phases do
        gm = make_fx(fn, _error_on_data_dependent_ops=False)(*example_args)
    found = []
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is torch.ops.repro_torch.bank_exchange.default:
            found.append(node.args[1])
        elif getattr(node.target, "namespace", "") in ("c10d",
                                                        "_c10d_functional"):
            found.append(str(node.target))
    return found


def assert_local(fn: Callable, *example_args: Any) -> None:
    """Raise unless fn, traced on the example arguments, holds no exchange
    of a BankGrid and no torch.distributed collective."""
    found = census(fn, *example_args)
    if found:
        raise AssertionError(
            f"bank-local phase contains {len(found)} exchange or collective "
            f"op(s) {found}; inter-bank communication must go through an "
            "exchange phase (Takeaway 3)")

