"""The program census (`repro_torch.core.census`), the roofline and
suitability scoring on it, and the graph builders of `dispatch.graph`,
against the reference's HLO census (`repro.core.hlo_analysis`,
`repro.dispatch.graph.ops_from_hlo`) on the same programs written in each
framework.

Tolerances: matrix-product FLOPs and the product's (op class, dtype class)
counts are equal exactly; so are elementwise counts of one op. Where
XLA:CPU's own lowering adds work the census does not see (two-stage
reductions: a reduce-window pre-pass of n/32 elements; a divide by a
constant rewritten to a reciprocal multiply), the case says so.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import REDUCED
from repro.core.hlo_analysis import analyze_hlo
from repro.dispatch.graph import _dtype_class, ops_from_hlo
from repro.models import Shardings
from repro.models import layers as JL
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.configs import get_arch
from repro_torch.core import census
from repro_torch.core.census import analyze_program, dtype_class, op_mix
from repro_torch.core.pim_model import TPU_V5E, UPMEM_2556
from repro_torch.core.roofline import (render_markdown_table,
                                       roofline_from_analysis,
                                       roofline_of_fn, what_would_move_it)
from repro_torch.core.suitability import score
from repro_torch.dispatch.graph import (OpGraph, node_from_fn,
                                        ops_from_program)
from repro_torch.dispatch.placement import plan
from repro_torch.models import forward, init_cache, init_params, tree_map
from repro_torch.models import layers as TL


def _ref(fn, *args):
    text = jax.jit(fn).lower(*args).compile().as_text()
    return analyze_hlo(text), ops_from_hlo(text)


def _pair(shape, dtype, seed=0):
    """The same values as a jax array and a torch tensor."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


# ------------------------------------------------------------------ #
# the counterparts of tests/test_analysis.py
# ------------------------------------------------------------------ #

HLO_NAME = {torch.float64: "f64", torch.float32: "f32",
            torch.bfloat16: "bf16", torch.float16: "f16",
            torch.int64: "s64", torch.int32: "s32", torch.uint32: "u32",
            torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
            torch.bool: "pred"}


def test_value_bytes_and_dtype_classes():
    """Tensor bytes from shape and dtype (the counterpart of the
    reference's HLO shape parsing), and the dtype classes equal the
    reference's `_dtype_class` on the same types (bool -> int8)."""
    prog = census.trace_program(lambda a, b: (a * 2, b + 1),
                                torch.zeros(128, 256),
                                torch.zeros(8, dtype=torch.bfloat16))
    assert prog.inputs[0].nbytes == 128 * 256 * 4
    assert prog.inputs[1].nbytes == 16
    assert prog.tracing == "fake"
    for dt, name in HLO_NAME.items():
        assert dtype_class(dt) == _dtype_class(name), dt


def test_matmul_flops_exact():
    m, k, n = 256, 512, 128
    an = analyze_program(lambda x, y: x @ y, torch.zeros(m, k),
                         torch.zeros(k, n))
    want = 2 * m * k * n
    assert an.dot_flops == want
    ref, _ = _ref(lambda x, y: x @ y, jnp.zeros((m, k)), jnp.zeros((k, n)))
    assert an.dot_flops == ref.dot_flops
    io = (m * k + k * n + m * n) * 4
    assert an.hbm_bytes == io
    assert io <= ref.hbm_bytes <= 3 * io


def test_loops_unroll_exactly():
    """The reference multiplies a while body by its parsed trip count; a
    Python loop unrolls in the trace, so the count is exact with no
    trip-count parse."""
    t = 17
    a = torch.zeros(64, 64)

    def f(x):
        for _ in range(t):
            x = x @ x * 0.5
        return x

    def g(x):
        def body(c, _):
            return c @ c * 0.5, ()
        return jax.lax.scan(body, x, None, length=t)[0]

    an = analyze_program(f, a)
    per_iter = 2 * 64 * 64 * 64
    assert an.dot_flops == t * per_iter
    assert an.dot_flops == _ref(g, jnp.zeros((64, 64)))[0].dot_flops
    assert an.op_census["dot"] == t


def test_roofline_terms_and_dominance():
    m = 4096
    with FakeTensorMode():
        a = torch.empty(m, m, dtype=torch.bfloat16)
    rep, an = roofline_of_fn(lambda x, y: x @ y, a, a, name="mm",
                             n_chips=1, model_flops=2 * m ** 3)
    # one 4096^3 bf16 matmul on v5e: compute-bound
    assert rep.dominant == "compute"
    assert rep.compute_s == pytest.approx(2 * m ** 3 / 197e12, rel=1e-12)
    assert rep.useful_compute_ratio == 1.0
    assert an.tracing == "fake"
    assert "compute-bound" in what_would_move_it(rep)
    assert "| mm | **compute** |" in render_markdown_table([rep])


def test_streaming_is_memory_bound():
    x = torch.zeros(1 << 22)
    an = analyze_program(lambda v: v + 1.0, x)
    rep = roofline_from_analysis(an, name="va", n_chips=1,
                                 model_flops=float(x.numel()))
    assert rep.dominant == "memory"
    assert an.hbm_bytes == 2 * 4 * x.numel()


def test_suitability_kt1_kt2_kt3():
    # VA-like: int add stream -> suitable on UPMEM
    x = torch.zeros(1 << 20, dtype=torch.int32)
    rep = score(analyze_program(lambda a, b: a + b, x, x), name="va",
                machine="upmem_2556")
    assert rep.memory_bound and rep.simple_ops and rep.low_comm
    assert rep.pim_suitable

    # matmul: operational intensity >> balance -> NOT memory-bound
    a = torch.zeros(2048, 2048)
    rep2 = score(analyze_program(lambda p, q: p @ q, a, a), name="mm",
                 machine="tpu_v5e")
    assert not rep2.memory_bound
    assert not rep2.pim_suitable

    # float divide stream -> complex-op heavy (KT2)
    xf = x.float()
    rep3 = score(analyze_program(lambda p, q: p / (q + 2.0), xf, xf),
                 name="div", machine="upmem_2556")
    assert rep3.complex_frac > 0.3
    assert not rep3.pim_suitable


def test_machine_balance_inversion():
    """DESIGN.md §2: the DPU is compute-bound where the TPU is memory-bound
    — the machine balance points sit on opposite sides of 1 op/byte."""
    assert UPMEM_2556.as_machine().balance < 1.0 < TPU_V5E.balance


def test_op_mix_census():
    xj, xt = _pair((1 << 16,), "float32")
    an = analyze_program(lambda a: torch.tanh(a) * a, xt)
    mix = op_mix(an)
    assert mix["complex_frac"] > 0.3     # tanh + multiply
    assert mix["total_arith_ops"] > 0
    ref, _ = _ref(lambda a: jnp.tanh(a) * a, xj)
    from repro.core.hlo_analysis import op_mix as j_op_mix
    assert mix["complex_frac"] == j_op_mix(ref)["complex_frac"]


# ------------------------------------------------------------------ #
# op classes: pow 2, softmax, mean, the int8 band
# ------------------------------------------------------------------ #

def test_square_is_a_multiply():
    """`x.square()` traces as pow(x, 2): a multiply, as `jnp.square` is in
    the reference, not a transcendental power (which would move KT2)."""
    xj, xt = _pair((8, 64), "float32")
    an = analyze_program(lambda a: a.square(), xt)
    assert an.op_census["multiply"] == 1 and "power" not in an.op_census
    assert an.ops == _ref(jnp.square, xj)[1] == {("mul", "float"): 512.0}
    assert an.flops == 512.0
    an3 = analyze_program(lambda a: a ** 3, xt)
    assert an3.ops == {("transc", "float"): 512.0}


def test_softmax_counts_as_its_parts():
    """`_softmax` counts as max (compare), sub, exp, sum (add) and divide,
    per element, in the op census and the (op, dtype) counts. The
    reference's keys are the same; its two reductions each add XLA:CPU's
    reduce-window pre-pass (n/32 elements)."""
    xj, xt = _pair((8, 64), "float32")
    an = analyze_program(lambda a: torch.softmax(a, -1), xt)
    n = 512.0
    assert an.ops == {(c, "float"): n for c in
                      ("compare", "sub", "transc", "add", "div")}
    assert an.op_census["reduce"] == 2
    for code in ("subtract", "exponential", "divide"):
        assert an.op_census[code] == 1
    ref = _ref(lambda a: jax.nn.softmax(a, axis=-1), xj)[1]
    assert set(ref) == set(an.ops)
    for k, v in an.ops.items():
        want = n + n / 32 if k[0] in ("compare", "add") else n
        assert ref[k] == want, k
    assert an.hbm_bytes == 2 * 4 * n          # one fused pass


def test_mean_counts_a_sum_and_a_divide():
    """`mean` counts its sum (one add per input element) and one divide
    per output element. The reference's XLA:CPU rewrites the divide by
    the constant row length into a reciprocal multiply (its `mul` key)."""
    xj, xt = _pair((8, 64), "float32")
    an = analyze_program(lambda a: a.mean(-1), xt)
    assert an.ops == {("add", "float"): 512.0, ("div", "float"): 8.0}
    assert _ref(lambda a: jnp.mean(a, axis=-1), xj)[1] == \
        {("add", "float"): 512.0 + 16.0, ("mul", "float"): 8.0}


def test_rms_norm_is_one_fused_pass():
    """Unfused, a norm counts six round trips; fused, its input is read
    once per reduction group and its output written once."""
    cfg = T_REDUCED["granite-3-8b"]
    x = torch.zeros(4, 16, cfg.d_model)
    p = {"scale": torch.ones(cfg.d_model)}
    an = analyze_program(lambda a: TL.apply_norm(a, p, cfg), x)
    n, d = x.numel(), cfg.d_model
    # square + mean (reads x), add + rsqrt (rows), x * r * scale (reads x,
    # the rows, the scale; writes the output)
    assert an.hbm_bytes == 4 * (n + 64 + 64 + 64 + n + 64 + d + n)


def test_int8_expert_products_multiply_in_the_int8_band():
    """The port's CPU int8 expert contraction is an int32 einsum of
    widened int8 operands (`layers.int8_expert_matmul`); the walk back
    through the widening converts finds int8: multiplies at int8, adds at
    the int32 accumulator — equal to `ops_from_hlo` on the reference's
    int8 expert FFN (`moe_expert_ffn_q8`) on the same shapes."""
    name = "qwen2-moe-a2.7b"
    cfg = dataclasses.replace(REDUCED[name], quant="int8")
    tcfg = dataclasses.replace(T_REDUCED[name], quant="int8")
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    rng = np.random.default_rng(0)
    buf = rng.normal(size=(2, e, 5, d)).astype(np.float32)
    w = {k: rng.normal(size=s).astype(np.float32) for k, s in
         (("wu", (e, d, f)), ("wg", (e, d, f)), ("wd", (e, f, d)))}
    jq = {k: JL.quantize_q8(jnp.asarray(v)) for k, v in w.items()}
    _, ref = _ref(lambda b, wu, su, wd, sd, wg, sg: JL.moe_expert_ffn_q8(
        b, wu, su, wd, sd, cfg, Shardings(None), wg, sg),
        jnp.asarray(buf), *jq["wu"], *jq["wd"], *jq["wg"])
    tq = {k: TL.quantize_q8(torch.from_numpy(v)) for k, v in w.items()}
    ops = ops_from_program(lambda b, q8: TL.moe_expert_ffn_q8(b, q8, tcfg),
                           torch.from_numpy(buf), tq)
    pairs = 3 * 2 * e * 5 * d * f
    assert ops[("mul", "int8")] == ref[("mul", "int8")] == pairs
    assert ops[("add", "int32")] == ref[("add", "int32")] == pairs
    assert ("mul", "int32") not in ops and ("mul", "int32") not in ref


@pytest.mark.parametrize("kv", ["int8", "int32"])
def test_widened_integer_operand_is_read_at_the_product_width(kv):
    """The int-attention proxy widens its int8 (or int32) cache to int32
    before an int32 x int32 dot, as `dispatch.workloads._attend` does:
    XLA materializes the widened operand, so the reference charges the
    dot's read at 4 bytes an element whatever the storage; the census
    reads an integer product's operands at its multiply class's width
    (`census._product_width`), and its bytes equal the reference's. An
    int8 x int8 product into int32 (the expert path above) still reads
    int8."""
    rng = np.random.default_rng(1)
    q = rng.integers(-64, 64, size=(2, 4, 16)).astype(np.int32)
    k = rng.integers(-64, 64, size=(96, 4, 16)).astype(np.int32)

    def jfn(a, b):
        return jnp.einsum("bhd,shd->bhs", a, b.astype(jnp.int32))

    def tfn(a, b):
        return torch.einsum("bhd,shd->bhs", a, b.to(torch.int32))
    an, _ = _ref(jfn, jnp.asarray(q), jnp.asarray(k, getattr(jnp, kv)))
    got = analyze_program(tfn, torch.from_numpy(q),
                          torch.from_numpy(k).to(getattr(torch, kv)))
    assert got.hbm_bytes == an.hbm_bytes == (q.size + k.size) * 4 \
        + 2 * 4 * 96 * 4
    x8 = torch.from_numpy(k[:8]).to(torch.int8)
    w8 = torch.from_numpy(k[:, :, 0].T.copy()).to(torch.int8)
    int8 = analyze_program(lambda a, b: a.to(torch.int32) @ b.to(torch.int32),
                           x8.reshape(8, 64)[:, :4], w8[:4])
    assert int8.hbm_bytes == 8 * 4 + 4 * 96 + 8 * 96 * 4


def test_uint32_mask_counts_as_a_convert():
    """`x & 0xFFFFFFFF` of an int64 is the port's spelling of a uint32
    value: a free convert, no bitwise op; any other mask is a bitwise and."""
    x = torch.zeros(64, dtype=torch.int32)
    an = analyze_program(lambda a: (a.long() & 0xFFFFFFFF) * 3, x)
    assert an.ops == {("mul", "int64"): 64.0}
    an = analyze_program(lambda a: (a.long() & 0xFFFF) * 3, x)
    assert an.ops == {("mul", "int64"): 64.0, ("bitwise", "int64"): 64.0}


def test_contractions_written_as_a_sum_of_products():
    """`(a * b).sum(d)` with both factors spanning d is one matrix
    product (2 flops a pair, into dot_flops): GEMV as the port's PrIM
    `ref` writes it. A product with a factor broadcast along d stays a
    multiply and a reduction."""
    a, x = torch.zeros(32, 16), torch.zeros(16)
    an = analyze_program(lambda p, q: (p * q).sum(1), a, x)
    assert an.dot_flops == 2 * 32 * 16 and an.op_census["dot"] == 1
    assert an.ops == {("mul", "float"): 512.0, ("add", "float"): 512.0}
    for q, dim in ((x, 0), (torch.zeros(32, 1), 1)):
        an = analyze_program(lambda p, q: (p * q).sum(dim), a, q)
        assert an.dot_flops == 0 and an.op_census["multiply"] == 1


def test_moe_weighted_and_masked_sums_stay_reduces():
    """The MoE layer's gate-weighted combine (a sum over the top-k slots
    of the gathered expert rows times their broadcast gate weights) and
    its capacity positions (a sum of a product with a one-hot mask) are
    a multiply and a reduce in the reference's compiled HLO, and in the
    census: no dot FLOPs on either side, at batch 1 too. A sum that keeps
    no dim (the load-balance loss) is a reduce as well."""
    from repro_torch.models import layers as TL
    for b in (8, 1):
        g = np.random.default_rng(b).standard_normal((b, 3, 2, 64),
                                                     np.float32)
        w = np.abs(g[..., 0])
        jan = analyze_hlo(jax.jit(lambda g, w: jnp.sum(
            g * w[..., None], axis=2)).lower(g, w).compile().as_text())
        an = analyze_program(lambda g, w: (g * w[..., None]).sum(2),
                             torch.from_numpy(g), torch.from_numpy(w))
        assert jan.dot_flops == an.dot_flops == 0
        assert an.op_census["multiply"] == 1 and an.op_census["reduce"] == 1
    cfg = T_REDUCED["mixtral-8x7b"]
    x = torch.randn(4, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    logits = torch.randn(4, 6, cfg.n_experts)
    an = analyze_program(lambda x, l: TL._dispatch_rows(x, l, cfg), x, logits)
    assert an.dot_flops == 0
    e = np.ones(8, np.float32)
    assert analyze_hlo(jax.jit(lambda a, b: jnp.sum(a * b)).lower(e, e)
                       .compile().as_text()).dot_flops == 0
    assert analyze_program(lambda a, b: (a * b).sum(), torch.ones(8),
                           torch.ones(8)).dot_flops == 0


def test_data_dependent_programs_trace_for_real():
    """A program that reads values on the host raises in the fake trace
    and is then traced for real on CPU copies; its arguments stay as they
    were. Fake arguments cannot be read."""
    x = torch.arange(16, dtype=torch.int32)
    keep = x.clone()

    def f(v):
        v.add_(1)
        return v[v > 8].sum()
    an = analyze_program(f, x)
    assert an.tracing == "real"
    assert torch.equal(x, keep)
    with FakeTensorMode():
        fx = torch.empty(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="real tensors"):
        analyze_program(f, fx)


# ------------------------------------------------------------------ #
# graph builders
# ------------------------------------------------------------------ #

def test_ops_from_program_counts_elements():
    n, k, m = 32, 16, 8
    ops = ops_from_program(lambda a, b: a @ b, torch.ones(n, k),
                           torch.ones(k, m))
    assert ops == ops_from_hlo(jax.jit(lambda a, b: a @ b).lower(
        jnp.ones((n, k)), jnp.ones((k, m))).compile().as_text())
    assert ops[("mul", "float")] == n * k * m
    ops = ops_from_program(lambda a, b: a + b,
                           torch.ones(64, dtype=torch.int32),
                           torch.ones(64, dtype=torch.int32))
    assert ops == {("add", "int32"): 64.0}


def test_from_program_unit_graph():
    """Fine-grained graph of a program: the product, then the maximum and
    the sum of squares fused into one group (a sum that keeps no dim is a
    multiply and a reduce, as XLA keeps the reference's twin), costed
    nodes wired by data flow."""
    def f(x, w):
        h = torch.clamp_min(x @ w, 0)
        return torch.sum(h * h)

    g = OpGraph.from_program(f, torch.ones(64, 32), torch.ones(32, 16),
                             name="relu-gemv")
    dot = next(n for n in g.nodes.values() if n.kind == "dot")
    assert dot.flops == 2 * 64 * 32 * 16
    assert g.is_chain and plan(g).method == "dp"
    assert g.input_bytes == 4 * (64 * 32 + 32 * 16)
    assert [g.nodes[n].kind for n in g.topo_order()] == ["dot", "fusion"]


def test_node_from_fn_costs_a_stage():
    x, w = torch.ones(4, 64), torch.ones(64, 128)
    node = node_from_fn("proj", lambda a, b: (a @ b, a), x, w,
                        kind="gemv", exchange_bytes=7.0)
    assert node.kind == "gemv" and node.exchange_bytes == 7.0
    assert node.flops == 2 * 4 * 64 * 128
    assert node.out_bytes == 4 * (4 * 128 + 4 * 64)
    assert node.ops == {("mul", "float"): 4 * 64 * 128.0,
                        ("add", "float"): 4 * 64 * 128.0}
    assert node.meta["analysis"].hbm_bytes == 4 * (4 * 64 + 64 * 128
                                                   + 4 * 128)


# ------------------------------------------------------------------ #
# the full-width decode step
# ------------------------------------------------------------------ #

def test_full_width_granite_decode_census():
    """granite-3-8b's decode step as the serving engine runs it (40
    layers, bf16, 4 slots x 2048), parameters under FakeTensorMode: no
    memory is allocated, the step is memory-bound on the modelled TPU and
    its bytes are at least its weights' plus its KV cache's."""
    cfg = get_arch("granite-3-8b")
    with FakeTensorMode():
        params = init_params(0, cfg, device="cpu")
        cache = init_cache(cfg, 4, 2048, device="cpu")
    leaves = []
    tree_map(leaves.append, params)
    weights = sum(t.numel() * t.element_size() for t in leaves)
    kv = 4 * 2048 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * 2
    an = analyze_program(
        lambda p, c, t: forward(p, cfg, tokens=t, cache=c)[0], params,
        cache, torch.ones(4, 1, dtype=torch.int32))
    assert an.tracing == "fake"
    assert score(an, name="decode", machine="tpu_v5e").memory_bound
    assert an.hbm_bytes >= weights + kv
    assert an.hbm_bytes <= 1.1 * (weights + kv)
    # every weight matrix multiplies the 4 tokens once (embed is a gather)
    assert an.dot_flops >= 2 * 4 * (weights / 2 - cfg.padded_vocab
                                    * cfg.d_model)
