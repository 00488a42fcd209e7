"""Program census: FLOPs, memory traffic and op mix of a PyTorch program.

The port's counterpart of `repro.core.hlo_analysis`. The reference
compiles a step with `jax.jit(fn).lower(...).compile()` and parses the
HLO text; nothing runs. Here `analyze_program(fn, *example_args)` runs
`fn` once on fake CPU tensors (`FakeTensorMode`: shapes and dtypes, no
storage, no arithmetic) under a dispatch mode that records every aten op
after the core-aten decompositions, then counts the record. It gives
`ProgramAnalysis`, with `HloAnalysis`'s field names, which
`core.suitability`, `core.roofline` and `dispatch.graph` read.

Tracing rules:

  * The example arguments become fake CPU tensors of the same shapes and
    dtypes, wherever they live (the card, the CPU, another fake mode).
    Never the card or `meta`: every kernel wrapper of `kernels.ops` sends
    a tensor that is not on the CPU to its CUDA kernel, which cannot run
    on a tensor without storage. On the CPU each kernel call is its plain
    version, which is the kernel's contract, so a stage is counted with
    the same work whatever runs it on the card.
  * A program that reads values on the host (`.item()`, a boolean mask,
    `bincount`) cannot run on fake tensors. The trace's own exception
    says so, and the program is then run once for real on CPU copies of
    the arguments, at the caller's size. Fake arguments cannot be read:
    such a program then raises.
  * Python loops unroll in the trace, so every count is exact: there is
    no trip-count parse and no trip-count fallback.

Counting rules (the reference's, `hlo_analysis.py:381-558`):

  * FLOPs: a matrix product (`mm`, `bmm`, `addmm`, `baddbmm`, `_int_mm`,
    `convolution`, and a `sum` over a product whose two factors both span
    the summed dims, which is how PyTorch spells a contraction) counts
    2·M·N·K, into `dot_flops` too. An elementwise op counts one per
    output element (`_ELEMENTWISE_FLOP_HINT` for the transcendentals), a
    reduction one per input element.
  * Bytes: views are free, and so are dtype converts and copies
    (`_to_copy`, `clone`), as the reference's `_LAYOUT_ONLY` fusions are:
    a consumer reads through them at the source's size and dtype. Slice
    readers (`index`, `gather`, `index_select`, `embedding`) cost twice
    their output, in-place updates (`index_put_`, `copy_` into a view,
    `scatter`, `index_copy`) twice their update. A chain of elementwise
    ops on one shape whose intermediates each have one consumer is one
    fused group, ending at most in one reduction: its inputs are read
    once and its output written once, as XLA's loop fusion gives the
    reference. Constants made inside the program (`zeros`, `arange`,
    `full`) are read for free.
  * Op classes and dtype classes follow `dispatch/graph.py:46-138`:
    `pow(x, 2)` is a multiply, `_softmax` counts as its max, subtract,
    exp, sum and divide, `mean` as its sum plus a divide per output; bool
    counts as int8; an integer product multiplies at the narrowest
    integer type its factors were widened from (the int8 band,
    DESIGN.md §15) and adds at its accumulator's. `x & 0xFFFFFFFF` of an
    int64 is the port's spelling of a uint32 value and counts as the
    convert it stands for.
  * One card has no collectives: `collective_bytes` is 0 and
    `collectives` is empty. Exchange bytes reach the planner through
    `dispatch.graph.OpNode.exchange_bytes`, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter, defaultdict
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

# ---------------------------------------------------------------------------
# op and dtype classes (keyed like `pim_model.DPU_OP_COST`)
# ---------------------------------------------------------------------------

#: HLO opcode -> DPU_OP_COST op class (the reference's `graph._OP_CLASS`)
OP_CLASS = {
    "add": "add", "subtract": "sub", "negate": "sub",
    "multiply": "mul", "divide": "div", "remainder": "div",
    "and": "bitwise", "or": "bitwise", "xor": "bitwise", "not": "bitwise",
    "shift-left": "bitwise", "shift-right-logical": "bitwise",
    "shift-right-arithmetic": "bitwise",
    "compare": "compare", "select": "compare", "maximum": "compare",
    "minimum": "compare", "clamp": "compare", "abs": "compare",
    "floor": "compare", "ceiling": "compare", "round-nearest-afz": "compare",
    "round-nearest-even": "compare", "sign": "compare",
    "exponential": "transc", "exponential-minus-one": "transc",
    "log": "transc", "log-plus-one": "transc", "rsqrt": "transc",
    "sqrt": "transc", "cbrt": "transc", "tanh": "transc",
    "logistic": "transc", "sine": "transc", "cosine": "transc",
    "tan": "transc", "erf": "transc", "power": "transc", "atan2": "transc",
}

_ELEMENTWISE_FLOP_HINT = {
    # rough per-output-element flop counts for common non-dot compute
    "exponential": 8, "log": 8, "rsqrt": 4, "sqrt": 4, "tanh": 8,
    "logistic": 8, "divide": 4, "power": 10, "sine": 8, "cosine": 8,
    "erf": 8,
}

#: aten op (overload packet name) -> HLO opcode of its elementwise body
_ELEMENTWISE = {
    "add": "add", "sub": "subtract", "rsub": "subtract", "neg": "negate",
    "mul": "multiply", "div": "divide", "reciprocal": "divide",
    "floor_divide": "divide", "remainder": "remainder", "fmod": "remainder",
    "bitwise_and": "and", "logical_and": "and", "bitwise_or": "or",
    "logical_or": "or", "bitwise_xor": "xor", "logical_xor": "xor",
    "bitwise_not": "not", "logical_not": "not",
    "bitwise_left_shift": "shift-left", "__lshift__": "shift-left",
    "bitwise_right_shift": "shift-right", "__rshift__": "shift-right",
    "eq": "compare", "ne": "compare", "lt": "compare", "le": "compare",
    "gt": "compare", "ge": "compare", "isnan": "compare", "isinf": "compare",
    "where": "select", "masked_fill": "select",
    "maximum": "maximum", "minimum": "minimum", "clamp": "clamp",
    "clamp_min": "maximum", "clamp_max": "minimum", "abs": "abs",
    "floor": "floor", "ceil": "ceiling", "round": "round-nearest-even",
    "trunc": "round-nearest-afz", "sign": "sign",
    "exp": "exponential", "exp2": "exponential",
    "expm1": "exponential-minus-one", "log": "log", "log2": "log",
    "log1p": "log-plus-one", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "tanh": "tanh", "sigmoid": "logistic", "sin": "sine", "cos": "cosine",
    "tan": "tan", "erf": "erf", "pow": "power", "atan2": "atan2",
}

#: aten reduction -> op class of the per-input-element step
_REDUCE = {
    "sum": "add", "mean": "add", "cumsum": "add", "nansum": "add",
    "prod": "mul", "amax": "compare", "amin": "compare", "max": "compare",
    "min": "compare", "argmax": "compare", "argmin": "compare",
    "any": "bitwise", "all": "bitwise", "topk": "compare", "sort": "compare",
}

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "_int_mm", "convolution"}
_CONVERT = {"_to_copy", "clone", "copy", "contiguous", "_conj",
            "resolve_conj", "resolve_neg"}
_VIEW_EXTRA = {"_unsafe_view", "lift_fresh", "detach", "alias"}
_CREATE = {"zeros", "ones", "full", "empty", "empty_strided", "arange",
           "scalar_tensor", "full_like", "zeros_like", "ones_like",
           "empty_like", "lift_fresh_copy", "new_zeros", "new_ones",
           "new_full", "new_empty", "new_empty_strided", "eye", "linspace"}
_GATHER = {"index", "gather", "index_select", "embedding", "take",
           "_unsafe_index"}
#: in-place and scatter updates -> position of the update operand
_UPDATE = {"index_put_": 2, "index_put": 2, "_unsafe_index_put": 2,
           "copy_": 1, "index_copy_": 3, "index_copy": 3, "scatter": 3,
           "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
           "scatter_reduce": 3, "scatter_reduce_": 3, "index_add": 3,
           "index_add_": 3, "slice_scatter": 1, "select_scatter": 1,
           "fill_": None, "zero_": None}
#: ops a fused group may absorb although their output is not their
#: inputs' shape (XLA fuses a concatenate into its loop fusion)
_FUSE_CAT = {"cat"}

_INT_WIDTH = {"int8": 0, "int32": 1, "int64": 2}
_UINT32_MASK = 0xFFFFFFFF


def dtype_class(dtype: torch.dtype) -> str:
    """torch dtype -> DPU_OP_COST dtype class (Fig. 3's bands, plus the
    native int8 band; bool counts as int8, as the reference's pred)."""
    if dtype in (torch.float64, torch.complex128):
        return "double"
    if dtype.is_floating_point or dtype.is_complex:
        return "float"
    if dtype in (torch.int64, torch.uint64):
        return "int64"
    if dtype in (torch.int8, torch.uint8, torch.bool):
        return "int8"
    return "int32"


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


# ---------------------------------------------------------------------------
# the recorded program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Value:
    """One tensor of the program: a graph input, or an op's output (an
    in-place op's output is a new Value of the same tensor)."""
    shape: tuple
    stride: tuple
    dtype: torch.dtype
    producer: "Op | None" = None
    consumers: list = dataclasses.field(default_factory=list)
    is_output: bool = False

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * _itemsize(self.dtype)


@dataclasses.dataclass(eq=False)
class Op:
    """One aten op of the program, in execution order."""
    index: int
    name: str                   # overload packet name, e.g. "mm", "add_"
    ins: list                   # tensor operands (Values), in order
    outs: list                  # tensor results (Values)
    args: tuple                 # positional arguments, tensors as Values
    is_view: bool = False
    kind: str = ""
    opcode: str = ""            # HLO-style opcode of the op census


@dataclasses.dataclass
class Program:
    """A recorded program: its ops in order, inputs and outputs."""
    ops: list
    inputs: list                # Values of the argument tensors
    outputs: list               # Values of every tensor fn returned
    tracing: str                # "fake" or "real"


def _meta_of(t: torch.Tensor) -> tuple:
    return tuple(t.shape), tuple(t.stride()), t.dtype


class _Recorder(TorchDispatchMode):
    """Records every aten op that reaches dispatch, after applying the
    core-aten decompositions to functional ops (views and in-place ops
    are kept whole, as the byte rules need them)."""

    def __init__(self):
        super().__init__()
        from torch._decomp import core_aten_decompositions
        self.decomp = core_aten_decompositions()
        self.values: dict[int, Value] = {}
        self.keep: list = []        # tensors seen, so no id is reused
        self.ops: list[Op] = []

    def value(self, t: torch.Tensor) -> Value:
        v = self.values.get(id(t))
        if v is None:
            shape, stride, dtype = _meta_of(t)
            v = Value(shape, stride, dtype)
            self.values[id(t)] = v
            self.keep.append(t)
        return v

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if (func in self.decomp and not schema.is_mutable
                and not func.is_view):
            with self:
                out = self.decomp[func](*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        flat_in, _ = tree_flatten((args, kwargs))
        ins = [self.value(t) for t in flat_in if isinstance(t, torch.Tensor)]
        vargs = tuple(self.value(a) if isinstance(a, torch.Tensor) else a
                      for a in args)
        op = Op(len(self.ops), name, ins, [], vargs, func.is_view)
        for v in dict.fromkeys(ins):
            v.consumers.append(op)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                shape, stride, dtype = _meta_of(t)
                v = Value(shape, stride, dtype, producer=op)
                self.values[id(t)] = v
                self.keep.append(t)
                op.outs.append(v)
        self.ops.append(op)


def _data_dependent_errors() -> tuple:
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    from torch.fx.experimental.symbolic_shapes import \
        GuardOnDataDependentSymNode
    return (DataDependentOutputException, DynamicOutputShapeException,
            GuardOnDataDependentSymNode)


def _fake_args(flat: list) -> tuple:
    """(mode, the tensors of `flat` as fake CPU tensors of `mode`): a new
    fake mode, which also takes the real tensors `fn` closes over."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    out = []
    for t in flat:
        if isinstance(t, torch.Tensor):
            with mode:
                t = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                        device="cpu")
        out.append(t)
    return mode, out


def _real_args(flat: list) -> list:
    """CPU copies of the tensors of `flat` (the program may write its
    arguments in place)."""
    from torch._subclasses.fake_tensor import FakeTensor
    out = []
    for t in flat:
        if isinstance(t, FakeTensor):
            raise ValueError(
                "the program reads tensor values on the host, so it is "
                "traced for real: pass real tensors, not fake ones")
        out.append(t.detach().to("cpu", copy=True)
                   if isinstance(t, torch.Tensor) else t)
    return out


def trace_program(fn: Callable, *args, **kwargs) -> Program:
    """Record `fn(*args, **kwargs)` op by op: on fake CPU tensors, or for
    real on CPU copies where the program reads values on the host."""
    flat, spec = tree_flatten((args, kwargs))
    try:
        mode, fake = _fake_args(flat)
        return _record(fn, mode, fake, spec, "fake")
    except _data_dependent_errors():
        return _record(fn, None, _real_args(flat), spec, "real")


def _record(fn, mode, flat, spec, tracing) -> Program:
    rec = _Recorder()
    inputs = [rec.value(t) for t in flat if isinstance(t, torch.Tensor)]
    a, kw = tree_unflatten(flat, spec)
    if mode is None:
        with rec:
            out = fn(*a, **kw)
    else:
        with mode, rec:
            out = fn(*a, **kw)
    outputs = []
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor):
            v = rec.value(t)
            v.is_output = True
            outputs.append(v)
    prog = Program(rec.ops, inputs, outputs, tracing)
    _classify(prog)
    return prog


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def _scalar_args(op: Op) -> list:
    return [a for a in op.args if not isinstance(a, Value)]


def _classify(prog: Program) -> None:
    for op in prog.ops:
        op.kind, op.opcode = _kind(op)
    _find_contractions(prog)


def _kind(op: Op) -> tuple[str, str]:
    n = op.name
    base = n[:-1] if n.endswith("_") and not n.startswith("_") else n
    if not op.outs:                  # a host read: .item(), .device
        return "host", n
    if n in _VIEW_EXTRA or op.is_view:
        return "view", "bitcast"
    if n in _CONVERT:
        return "convert", "convert" if n == "_to_copy" else "copy"
    if base == "bitwise_and" and op.ins and op.ins[0].dtype == torch.int64 \
            and _UINT32_MASK in _scalar_args(op):
        return "convert", "convert"
    if n in _CREATE:
        return "create", "constant"
    if n in _MATMUL:
        return "matmul", "convolution" if n == "convolution" else "dot"
    if n in _UPDATE:
        return "update", "scatter"
    if n in _GATHER:
        return "gather", "gather"
    if n == "_softmax":
        return "softmax", "softmax"
    if n in _REDUCE:
        return "reduce", ("reduce-window" if base == "cumsum" else "reduce")
    if base in _ELEMENTWISE:
        code = _ELEMENTWISE[base]
        if code == "shift-right":
            code = ("shift-right-logical" if op.outs[0].dtype in
                    (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
                    else "shift-right-arithmetic")
        if code == "power" and isinstance(op.args[0], Value) \
                and op.args[1:] == (2,):
            code = "multiply"          # x.square(): jnp.square's multiply
        return ("inplace" if base != n else "elementwise"), code
    if n in _FUSE_CAT:
        return "elementwise", "concatenate"
    if n == "searchsorted":
        return "search", "compare"
    return "other", n


def _chain_to(v: Value) -> Value:
    """The value `v` is read from, through views and converts."""
    while v.producer is not None and v.producer.kind in ("view", "convert") \
            and v.producer.ins:
        v = v.producer.ins[0]
    return v


def _spans(operand: Value, out_shape: tuple, dims: list[int]) -> bool:
    """True when `operand`, broadcast to `out_shape`, varies along every
    dim of `dims` (it is neither missing there nor a stride-0 expand)."""
    off = len(out_shape) - len(operand.shape)
    for d in dims:
        if out_shape[d] == 1:
            continue
        if d < off:
            return False
        i = d - off
        if operand.shape[i] != out_shape[d] or operand.stride[i] == 0:
            return False
    return True


def _reduced_dims(op: Op) -> list[int]:
    x = op.ins[0]
    nd = len(x.shape)
    dims = op.args[1] if len(op.args) > 1 else None
    if dims is None or dims == [] or dims == ():
        return list(range(nd))
    if isinstance(dims, int):
        dims = [dims]
    return sorted({d % nd for d in dims}) if nd else []


def _find_contractions(prog: Program) -> None:
    """A `sum` over a product whose two factors both span the summed dims,
    the product feeding nothing else, is a contraction (XLA's
    dot_general): the pair counts as one matrix product."""
    for op in prog.ops:
        if op.kind != "reduce" or op.name != "sum" or not op.ins:
            continue
        x = op.ins[0]
        mul = x.producer
        if (mul is None or mul.kind != "elementwise"
                or mul.opcode != "multiply" or mul.name != "mul"
                or len(mul.ins) != 2 or mul.outs[0] is not x
                or x.consumers != [op] or x.is_output):
            continue
        dims = _reduced_dims(op)
        a, b = mul.args[0], mul.args[1]
        if not (isinstance(a, Value) and isinstance(b, Value)):
            continue
        if _spans(a, x.shape, dims) and _spans(b, x.shape, dims):
            mul.kind, mul.opcode = "contraction-product", "dot"
            op.kind, op.opcode = "contraction", "dot"


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _storage_class(v: Value, depth: int = 12) -> str:
    """Dtype class of the VALUES flowing through an integer operand: the
    narrowest integer class met walking back through widening converts
    and views (a narrowing convert truncates, so the narrower governs)."""
    c = dtype_class(v.dtype)
    if c not in _INT_WIDTH or depth <= 0:
        return c
    p = v.producer
    if p is not None and p.kind in ("view", "convert") and p.ins:
        inner = _storage_class(p.ins[0], depth - 1)
        if inner in _INT_WIDTH and _INT_WIDTH[inner] < _INT_WIDTH[c]:
            return inner
    return c


def _mul_class(operands: list, out_class: str) -> str:
    """Dtype class a product's multiplies run at: the widest integer
    operand class, resolved through widening plumbing (`_dot_mul_class`);
    float products price at the output class."""
    if out_class not in _INT_WIDTH:
        return out_class
    classes = [_storage_class(v) for v in operands[:2]]
    if not classes or any(c not in _INT_WIDTH for c in classes):
        return out_class
    return max(classes, key=_INT_WIDTH.__getitem__)


@dataclasses.dataclass(eq=False)
class Unit:
    """What the byte model charges as one: a fused group, a matrix
    product, or one op that moves memory. `ops` holds its members."""
    name: str
    kind: str                   # HLO-style: "fusion", "dot", "gather", ...
    ops: list
    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    out_bytes: float = 0.0
    counts: dict = dataclasses.field(default_factory=dict)
    preds: list = dataclasses.field(default_factory=list)


_FUSABLE = ("elementwise",)
_GROUP_SINK = ("elementwise", "reduce", "softmax")


def program_units(prog: Program) -> list[Unit]:
    """The program's costed units in execution order (fused groups,
    products, memory ops) with their data-flow predecessors: the nodes of
    `dispatch.graph.OpGraph.from_program`. Free ops (views, converts,
    constants, host reads) belong to none."""
    parent = {op: op for op in prog.ops}

    def find(o):
        while parent[o] is not o:
            parent[o] = parent[parent[o]]
            o = parent[o]
        return o

    def single_chain(v: Value, consumer: Op) -> Op | None:
        """The elementwise producer feeding `consumer` through `v` and
        nothing else (views and converts between them included)."""
        link = consumer
        while True:
            if v.is_output or v.consumers != [link]:
                return None
            p = v.producer
            if p is None:
                return None
            if p.kind in ("view", "convert") and p.ins:
                link, v = p, p.ins[0]
                continue
            return p if p.kind in _FUSABLE else None

    for op in prog.ops:
        if op.kind not in _GROUP_SINK or not op.outs:
            continue
        reads = op.ins[:1] if op.kind != "elementwise" else op.ins
        for v in reads:
            p = single_chain(v, op)
            if p is None:
                continue
            if p.outs[0].numel != v.numel:
                continue
            if op.kind == "elementwise" and op.opcode != "concatenate" \
                    and v.numel != op.outs[0].numel:
                continue
            parent[find(p)] = find(op)

    costed = [op for op in prog.ops if op.kind not in
              ("view", "convert", "create", "host")]
    members: dict[Op, list] = defaultdict(list)
    for op in costed:
        if op.kind == "contraction-product":
            continue                       # costed with its sum
        members[find(op)].append(op)
    units, unit_of = [], {}
    for root, ops in members.items():
        u = Unit(f"{root.opcode}.{root.index}", _unit_kind(ops), ops)
        for o in ops:
            unit_of[o] = u
        units.append(u)
    for op in prog.ops:                     # products join their sums
        if op.kind == "contraction-product":
            s = op.outs[0].consumers[0]
            unit_of[op] = unit_of[s]
            unit_of[s].ops.insert(0, op)
    for u in units:
        _cost(u, unit_of)
    return sorted(units, key=lambda u: u.ops[-1].index)


def _unit_kind(ops: list) -> str:
    if len(ops) > 1 and all(o.kind in _GROUP_SINK for o in ops):
        return "fusion"
    return ops[-1].opcode


def _read_bytes(v: Value) -> tuple[Value, float]:
    """(source, bytes) of reading `v`: its source through views and
    converts, at the source's dtype, no more elements than either holds;
    a constant made in the program is free."""
    src = _chain_to(v)
    if src.producer is not None and src.producer.kind == "create":
        return src, 0.0
    return src, float(min(v.numel, src.numel) * _itemsize(src.dtype))


def _cost(u: Unit, unit_of: dict) -> None:
    """Count `u`'s ops and charge its bytes: its external inputs read once
    and its output written once, or the rule of its memory op."""
    counts: dict = defaultdict(float)
    reads: dict[int, float] = {}
    preds: dict[int, Unit] = {}
    for op in u.ops:
        f, d = _count(op, counts)
        u.flops += f
        u.dot_flops += d
        for v in op.ins:
            src, b = _read_bytes(v)
            p = src.producer
            if p is not None and unit_of.get(p) is u:
                continue
            reads[id(src)] = max(reads.get(id(src), 0.0), b)
            if p in unit_of:
                preds[id(unit_of[p])] = unit_of[p]
    last = u.ops[-1]
    out = float(sum(v.nbytes for v in last.outs))
    if last.kind == "gather":
        u.hbm_bytes = 2.0 * out
    elif last.kind == "update":
        pos = _UPDATE[last.name]
        upd = last.args[pos] if pos is not None else None
        out = float(upd.nbytes if isinstance(upd, Value) else out)
        u.hbm_bytes = out if pos is None else 2.0 * out
    elif last.kind == "search":
        seq, queries = last.ins[0], last.ins[1]
        u.hbm_bytes = (queries.nbytes + out + queries.numel
                       * _search_steps(seq) * _itemsize(seq.dtype))
    else:
        u.hbm_bytes = sum(reads.values()) + out
    u.out_bytes = out
    u.counts = dict(counts)
    u.preds = list(preds.values())


def _search_steps(sorted_seq: Value) -> int:
    n = sorted_seq.shape[-1] if sorted_seq.shape else 1
    return max(math.ceil(math.log2(n + 1)), 1)


def _count(op: Op, counts: dict) -> tuple[float, float]:
    """Add `op`'s (op class, dtype class) element counts to `counts`;
    return its (flops, dot flops)."""
    k = op.kind
    out = op.outs[0] if op.outs else None
    if k == "contraction-product":
        return 0.0, 0.0                       # counted by its sum
    if k == "contraction":
        mul = op.ins[0].producer
        pairs = float(mul.outs[0].numel)
        counts[("mul", _mul_class(mul.ins, dtype_class(out.dtype)))] += pairs
        counts[("add", dtype_class(out.dtype))] += pairs
        return 2.0 * pairs, 2.0 * pairs
    if k == "matmul":
        pairs = _matmul_pairs(op)
        dt = dtype_class(out.dtype)
        counts[("mul", _mul_class(_matmul_operands(op), dt))] += pairs
        counts[("add", dt)] += pairs
        f = 2.0 * pairs
        if op.name in ("addmm", "baddbmm"):   # the bias add
            counts[("add", dt)] += float(out.numel)
            return f + out.numel, f
        return f, f
    if k in ("elementwise", "inplace"):
        code = op.opcode
        if code == "concatenate":
            return 0.0, 0.0
        n = float(out.numel)
        counts[(OP_CLASS[code], dtype_class(out.dtype))] += n
        return n * _ELEMENTWISE_FLOP_HINT.get(code, 1), 0.0
    if k == "reduce":
        x = op.ins[0]
        n = float(x.numel)
        counts[(_REDUCE[op.name], dtype_class(x.dtype))] += n
        f = n
        if op.name == "mean":                 # sum, then one divide each
            counts[("div", dtype_class(out.dtype))] += float(out.numel)
            f += 4.0 * out.numel
        return f, 0.0
    if k == "softmax":                        # max, sub, exp, sum, divide
        n = float(op.ins[0].numel)
        dt = dtype_class(out.dtype)
        for cls in ("compare", "sub", "transc", "add", "div"):
            counts[(cls, dt)] += n
        return n * (1 + 1 + 8 + 1 + 4), 0.0
    if k == "search":
        n = float(op.ins[1].numel * _search_steps(op.ins[0]))
        counts[("compare", dtype_class(op.ins[0].dtype))] += n
        return n, 0.0
    return 0.0, 0.0


def _matmul_operands(op: Op) -> list:
    if op.name in ("addmm", "baddbmm"):
        return op.ins[1:3]
    return op.ins[:2]


def _matmul_pairs(op: Op) -> float:
    """Multiply-add pairs of a matrix product: output elements times the
    contracted length."""
    out = op.outs[0]
    if op.name == "convolution":
        w = op.ins[1]
        return float(out.numel * max(w.numel // max(w.shape[0], 1), 1))
    a = _matmul_operands(op)[0]
    return float(out.numel * a.shape[-1])


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramAnalysis:
    flops: float
    dot_flops: float
    hbm_bytes: float
    collective_bytes: float
    collectives: list            # none on one card
    op_census: Counter           # HLO-style opcode -> count
    dot_details: list            # per product: flops, type, count, op_name
    largest_tensors: list        # (bytes, op name, type), 20 largest
    ops: dict                    # {(op class, dtype class): elements}
    tracing: str                 # "fake" or "real"

    @property
    def collective_breakdown(self) -> dict[str, int]:
        d: dict[str, int] = defaultdict(int)
        for c in self.collectives:
            d[c.opcode] += c.bytes
        return dict(d)


#: ops the census counts as their parts, as XLA's HLO spells them
_CENSUS_PARTS = {
    "_softmax": ("reduce", "subtract", "exponential", "reduce", "divide"),
    "mean": ("reduce", "divide"),
}


def _type_str(v: Value) -> str:
    return f"{str(v.dtype).removeprefix('torch.')}{list(v.shape)}"


def analyze(prog: Program) -> ProgramAnalysis:
    """Count a recorded program (`trace_program`)."""
    units = program_units(prog)
    census: Counter = Counter()
    for op in prog.ops:
        if op.kind not in ("contraction-product", "host"):
            census.update(_CENSUS_PARTS.get(op.name, (op.opcode,)))
    counts: dict = defaultdict(float)
    dots, largest = [], []
    for u in units:
        for k, n in u.counts.items():
            counts[k] += n
        if u.dot_flops:
            last = u.ops[-1]
            dots.append({"flops": u.dot_flops, "type": _type_str(last.outs[0]),
                         "count": 1, "op_name": u.name})
    for op in prog.ops:
        if op.kind in ("view", "convert", "create", "host",
                       "contraction-product"):
            continue
        for v in op.outs:
            if v.nbytes:
                largest.append((v.nbytes, f"{op.opcode}.{op.index}",
                                _type_str(v)[:60]))
    return ProgramAnalysis(
        flops=sum(u.flops for u in units),
        dot_flops=sum(u.dot_flops for u in units),
        hbm_bytes=sum(u.hbm_bytes for u in units),
        collective_bytes=0.0,
        collectives=[],
        op_census=census,
        dot_details=sorted(dots, key=lambda d: -d["flops"])[:50],
        largest_tensors=sorted(largest, key=lambda t: -t[0])[:20],
        ops=dict(counts),
        tracing=prog.tracing,
    )


def analyze_program(fn: Callable, *example_args,
                    **example_kwargs) -> ProgramAnalysis:
    """Census of `fn(*example_args, **example_kwargs)`: traced on fake CPU
    tensors (module docstring), never run on the card."""
    return analyze(trace_program(fn, *example_args, **example_kwargs))


def op_mix(analysis: ProgramAnalysis) -> dict[str, float]:
    """Paper Takeaway-2 style op-mix census: fraction of dynamic ops that are
    'simple' (add/sub/bitwise/compare) vs 'complex' (mul/div/transcendental)
    vs matmul."""
    simple = complex_ = matmul = other = 0
    simple_ops = {"add", "subtract", "and", "or", "xor", "not", "compare",
                  "select", "maximum", "minimum", "shift-left",
                  "shift-right-logical", "shift-right-arithmetic"}
    complex_ops = {"multiply", "divide", "power", "exponential", "log",
                   "rsqrt", "sqrt", "tanh", "logistic", "sine", "cosine",
                   "remainder", "erf", "atan2"}
    for oc, n in analysis.op_census.items():
        if oc in simple_ops:
            simple += n
        elif oc in complex_ops:
            complex_ += n
        elif oc in ("dot", "convolution"):
            matmul += n
        else:
            other += n
    total = max(simple + complex_ + matmul, 1)
    return {
        "simple_frac": simple / total,
        "complex_frac": complex_ / total,
        "matmul_frac": matmul / total,
        "total_arith_ops": simple + complex_ + matmul,
    }
