#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each of which raises (exit code != 0) on failure:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and cuDNN.
2. Build: every `src/repro_torch/kernels/csrc/*.cu` with nvcc for sm_90a.
3. Kernels against their plain PyTorch versions, at the serving path's
   shapes and at the reference test sweep's, in f32 and bf16, with CUDA-
   event timings of the kernel, the plain version and one PyTorch library
   call (scaled_dot_product_attention, a yardstick the port never calls),
   beside the least time the card could take (`bound_ms`).
4. Full width, 4 layers, f32: granite-3-8b prefill + 8 decode steps through
   the kernels and through the plain versions: every attention call of
   the kernel run also goes through the plain version in f32 and f64 on
   the same activations, and each kernel stays within CALL_TOL of f64 or
   no further from it than the plain f32 version; greedy tokens
   identical; the kernels' logits no further from an f64 run than
   LOGIT_F64_FACTOR times the plain f32 path's.
5. The main path: granite-3-8b at full depth and width in bf16, random
   weights from a seed, `ServeEngine(batch_slots=4, max_len=2048)` serving
   8 requests (prompts of 64-1500 tokens, 32 new tokens each) with
   continuous batching. Launch counters must show every attention call
   went through the kernels: 40 per decode step and 40 per admission.

The second-to-last line is the `kernels` JSON; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# H100 SXM data sheet: HBM3 bandwidth and dense peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version: |got - want| <= TOL * (1 + |want|). f32: the
# band of tests/test_kernels.py (summation order only). bf16: a few times
# the largest error measured on the H100 (decode 3.05e-5, prefill 3.9e-3),
# both sides rounding one f32 result to bf16
TOL = {("decode_attention", torch.float32): 1e-4,
       ("decode_attention", torch.bfloat16): 1e-3,
       ("flash_attention", torch.float32): 1e-4,
       ("flash_attention", torch.bfloat16): 1e-2}
# f32 full-width check. The random init (fan-in = the heads axis, as in the
# reference) gives attention scores in the hundreds, where one f32 ulp of a
# score (3e-5) moves an output by up to ~6e-5 of its scale: the kernel and
# the plain version, both f32, differ there by ~1e-4 (measured on the H100:
# prefill 1.46e-4, decode 2.1e-5). So every attention call is also run
# through the plain version in f64 on the same activations, and per kernel
# the worst max |kernel - f64| / max |f64| over the run must be within
# CALL_TOL, or no larger than the plain f32 version's worst.
CALL_TOL = 1e-4
# f32 rounding in any order of sums then moves the logits by ~1e-2
# relative, so the two paths' logits cannot agree to 1e-3 after 4 layers
# and 8 steps. Both are held to an f64 run of the plain path instead: the
# kernels' logits may be no further from it than the plain f32 path's
# (measured on the H100: kernels 2.35e-2, plain 4.10e-2).
LOGIT_F64_FACTOR = 1.0
SERVE_LAYERS = 40       # granite-3-8b at full depth

# (B, H, KVH, hd, W, lengths): the path's shape, then tests/test_kernels.py's
DECODE_CASES = [
    (4, 32, 8, 128, 2048, [1, 511, 1300, 2048]),
    (2, 8, 2, 64, 1000, 777),
    (1, 4, 4, 128, 512, 512),
    (2, 16, 2, 64, 2048, 1),
]
# (Sq, Skv, H, KVH, hd, causal, window): the path's shapes, then the sweep's
FLASH_CASES = [
    (1024, 1024, 32, 8, 128, True, 0),
    (300, 300, 32, 8, 128, True, 0),
    (1024, 1024, 32, 8, 128, True, 64),
    (300, 300, 4, 2, 64, True, 0),
    (512, 512, 2, 2, 128, True, 64),
    (256, 700, 4, 1, 64, False, 0),
    (128, 512, 2, 2, 64, True, 32),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, arg_sets, reps: int = 7, per_rep: int = 10) -> float:
    """Median over `reps` of the mean CUDA-event time of `per_rep` calls,
    cycling through `arg_sets` so consecutive calls find cold operands."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(per_rep):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, dtype, got, want) -> float:
    err = (got.float() - want.float()).abs()
    tol = TOL[(name, dtype)]
    worst = float((err - tol * (1 + want.float().abs())).max())
    if worst > 0:
        raise AssertionError(f"{name} {dtype}: kernel disagrees with its plain "
                             f"version (max abs err {float(err.max()):.3g}, "
                             f"tolerance {tol})")
    return float(err.max())


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #

def decode_case(ops, ref, case, dtype, gen, timed):
    b, h, kvh, hd, w, lengths = case
    dev = "cuda"
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    # four copies of the cache (> L2) so timed launches read it cold, as
    # each of the model's 40 layers does
    sets = [(mk(b, h, hd), mk(b, w, kvh, hd), mk(b, w, kvh, hd))
            for _ in range(4 if timed else 1)]
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    lens = lens.expand(b).contiguous()
    q, k, v = sets[0]
    err = check_close("decode_attention", dtype,
                      ops.decode_attention(q, k, v, lengths),
                      ref.decode_attention(q, k, v, lens))
    row = {"case": f"B{b} H{h} KVH{kvh} hd{hd} W{w} len{lengths}",
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err}
    if not timed:
        return row
    isz = torch.finfo(dtype).bits // 8
    n_rows = int(lens.sum())
    nbytes = (n_rows * kvh * hd * 2 + 2 * b * h * hd) * isz + 4 * b
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * n_rows * h * hd,
                                             dtype)
    row["ms"] = median_ms(lambda q, k, v: ops.decode_attention(q, k, v, lens),
                          sets)
    row["plain_ms"] = median_ms(
        lambda q, k, v: ref.decode_attention(q, k, v, lens), sets)
    mask = (torch.arange(w, device=dev)[None, :] < lens[:, None])[:, None, None]

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    row["library_ms"] = median_ms(library, sets)
    return row


def flash_case(ops, ref, case, dtype, gen, timed):
    sq, skv, h, kvh, hd, causal, window = case
    dev = "cuda"
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    sets = [(mk(1, sq, h, hd), mk(1, skv, kvh, hd), mk(1, skv, kvh, hd))
            for _ in range(4 if timed else 1)]
    q, k, v = sets[0]
    err = check_close("flash_attention", dtype,
                      ops.flash_attention(q, k, v, causal, window),
                      ref.flash_attention(q, k, v, causal, window))
    row = {"case": f"Sq{sq} Skv{skv} H{h} KVH{kvh} hd{hd} causal{int(causal)} "
                   f"window{window}",
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err}
    if not timed:
        return row
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    pairs = int(mask.sum())
    isz = torch.finfo(dtype).bits // 8
    nbytes = (2 * sq * h * hd + 2 * skv * kvh * hd) * isz
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * pairs * h * hd,
                                             dtype)
    row["ms"] = median_ms(
        lambda q, k, v: ops.flash_attention(q, k, v, causal, window), sets)
    row["plain_ms"] = median_ms(
        lambda q, k, v: ref.flash_attention(q, k, v, causal, window), sets)
    lib_mask = None if (causal and not window and sq == skv) \
        else mask.to(dev)

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=lib_mask, is_causal=lib_mask is None, enable_gqa=True)
    row["library_ms"] = median_ms(library, sets)
    return row


def kernel_checks(ops, ref):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"decode_attention": [], "flash_attention": []}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(DECODE_CASES):
            rows["decode_attention"].append(
                decode_case(ops, ref, case, dtype, gen, timed=i == 0))
        for i, case in enumerate(FLASH_CASES):
            rows["flash_attention"].append(
                flash_case(ops, ref, case, dtype, gen, timed=i <= 1))
    torch.cuda.synchronize()
    for name, rs in rows.items():
        for r in rs:
            log(f"  {name} {r['dtype']:8s} {r['case']}: " + ", ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items() if k not in ("case", "dtype")))
    return rows


# --------------------------------------------------------------------- #
# phase 4: full width, 4 layers, f32: kernels vs plain versions
# --------------------------------------------------------------------- #

@contextmanager
def plain_attention(ops, ref):
    """Route the model's attention calls to the plain versions."""
    saved = ops.decode_attention, ops.flash_attention
    ops.decode_attention, ops.flash_attention = (ref.decode_attention,
                                                 ref.flash_attention)
    try:
        yield
    finally:
        ops.decode_attention, ops.flash_attention = saved


@contextmanager
def checked_attention(ops, ref, worst):
    """Run the model's attention calls through the kernels and also through
    the plain version in f32 and in f64 on the same activations. `worst`
    collects, per kernel, the largest max|x - y| / max|f64| over the calls
    for x, y = kernel and plain, kernel and f64, plain and f64."""
    saved = ops.decode_attention, ops.flash_attention

    def wide(a):
        return a.double() if torch.is_tensor(a) and a.is_floating_point() \
            else a

    def wrap(name, kernel_fn, plain_fn):
        def fn(*args, **kwargs):
            got = kernel_fn(*args, **kwargs)
            want = plain_fn(*args, **kwargs)
            exact = plain_fn(*map(wide, args), **kwargs)
            scale = exact.abs().max()
            w = worst.setdefault(name, dict.fromkeys(
                ("kernel-plain", "kernel-f64", "plain-f64"), 0.0))
            for key, x, y in (("kernel-plain", got, want),
                              ("kernel-f64", got, exact),
                              ("plain-f64", want, exact)):
                w[key] = max(w[key], float((x - y).abs().max() / scale))
            return got
        return fn

    ops.decode_attention = wrap("decode_attention", saved[0],
                                ref.decode_attention)
    ops.flash_attention = wrap("flash_attention", saved[1],
                               ref.flash_attention)
    try:
        yield
    finally:
        ops.decode_attention, ops.flash_attention = saved


def full_width_check(ops, ref):
    """Prefill + 8 greedy decode steps through the kernels (each call held
    to its plain version), through the plain versions, and (teacher-forced
    on the kernels' tokens) through the plain versions in f64 with f64
    weights."""
    from repro_torch.configs import get_arch
    from repro_torch.models import forward, init_cache, init_params, tree_map

    cfg = dataclasses.replace(get_arch("granite-3-8b"), n_layers=4,
                              dtype="float32")
    params = init_params(SEED, cfg, "cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg.vocab_size, (1, 300), generator=gen)
    prompt = prompt.to("cuda")

    def run(cfg, params, forced=None):
        cache = init_cache(cfg, 1, 512, "cuda")
        logits, cache, _ = forward(params, cfg, tokens=prompt, cache=cache)
        outs, toks = [logits[:, -1]], []
        for i in range(8):
            tok = outs[-1].argmax(-1) if forced is None else torch.tensor(
                [forced[i]], device="cuda")
            toks.append(int(tok))
            logits, cache, _ = forward(params, cfg, tokens=tok[:, None],
                                       cache=cache)
            outs.append(logits[:, -1])
        return toks, torch.stack(outs)[..., :cfg.vocab_size].double()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    worst = {}
    with torch.no_grad():
        with checked_attention(ops, ref, worst):
            toks_k, lg_k = run(cfg, params)
        with plain_attention(ops, ref):
            toks_p, lg_p = run(cfg, params)
            params = tree_map(lambda t: t.double(), params)
            _, lg_64 = run(dataclasses.replace(cfg, dtype="float64"), params,
                           forced=toks_k)
    err_k, err_p = rel(lg_k, lg_64), rel(lg_p, lg_64)
    for name, w in worst.items():
        log(f"  {name} calls, worst max |x - y| / max |f64|: "
            + ", ".join(f"{k} {v:.3g}" for k, v in w.items())
            + f" (kernel-f64 limit: {CALL_TOL} or plain-f64)")
    log(f"  tokens kernels {toks_k}")
    log(f"  tokens plain   {toks_p}")
    log(f"  logits max rel diff: kernels vs plain {rel(lg_k, lg_p):.3g}; "
        f"vs f64: kernels {err_k:.3g}, plain {err_p:.3g} "
        f"(limit {LOGIT_F64_FACTOR} x plain)")
    if sorted(worst) != ["decode_attention", "flash_attention"]:
        raise AssertionError(f"full-width f32: attention calls seen {worst}")
    for name, w in worst.items():
        if not w["kernel-f64"] <= max(CALL_TOL, w["plain-f64"]):
            raise AssertionError(f"full-width f32: {name} kernel is "
                                 f"{w['kernel-f64']:.3g} of the output's "
                                 f"scale from f64, the plain version "
                                 f"{w['plain-f64']:.3g} (limit {CALL_TOL})")
    if toks_k != toks_p:
        raise AssertionError("full-width f32: kernel and plain paths chose "
                             "different tokens")
    if not (torch.isfinite(lg_k).all() and err_k <= LOGIT_F64_FACTOR * err_p):
        raise AssertionError(f"full-width f32: kernel logits are {err_k:.3g} "
                             f"from f64, the plain path's {err_p:.3g}")


# --------------------------------------------------------------------- #
# phase 5: the main path
# --------------------------------------------------------------------- #

def main_path(kernels):
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, tree_map
    from repro_torch.serve import Request, ServeEngine

    cfg = get_arch("granite-3-8b")
    assert cfg.n_layers == SERVE_LAYERS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(SEED, cfg, "cuda")
    torch.cuda.synchronize()
    leaves = []
    tree_map(leaves.append, params)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"  init_params {time.perf_counter() - t0:.2f}s: "
        f"{sum(t.numel() for t in leaves)} parameters, {weight_bytes} bytes")

    engine = ServeEngine(cfg, params, batch_slots=4, max_len=2048,
                         seed=SEED, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    lens = torch.randint(64, 1501, (8,), generator=gen).tolist()
    reqs = [Request(i, torch.randint(0, cfg.vocab_size, (n,), generator=gen),
                    32) for i, n in enumerate(lens)]

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}

    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in done:
        if len(r.out_tokens) != r.max_new_tokens:
            raise AssertionError(f"req {r.rid}: {len(r.out_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"req {r.rid}: vocab-padding token")
    want = {"decode_attention": SERVE_LAYERS * engine.n_decode_steps,
            "flash_attention": SERVE_LAYERS * engine.n_prefills}
    log(f"  launches {launches}, expected {want} ({engine.n_decode_steps} "
        f"decode steps, {engine.n_prefills} admissions)")
    if launches != want or engine.n_prefills != len(reqs):
        raise AssertionError("launch counts do not match the path")

    decode_tokens = sum(len(r.out_tokens) - 1 for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        log(f"  req {r.rid}: prompt {len(r.prompt)}, TTFT "
            f"{(r.first_token_at - t0) * 1e3:.1f} ms, tokens "
            f"{r.out_tokens[:8]}...")
    log(f"  serve wall {wall:.3f}s; prefill {engine.prefill_s:.3f}s over "
        f"{engine.n_prefills} admissions "
        f"({engine.prefill_s / engine.n_prefills * 1e3:.1f} ms each); decode "
        f"{engine.decode_s * 1e3 / engine.n_decode_steps:.2f} ms/step over "
        f"{engine.n_decode_steps} steps, "
        f"{decode_tokens / engine.decode_s:.1f} decode tokens/s")
    log(f"  weight bytes {weight_bytes}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops, ref

    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.device_count()} card(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 2: build")
    secs = _build.build_all()
    log(f"  built {[s.name for s in _build.sources()]} in {secs:.1f}s "
        f"into {_build.build_dir()}")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 3: kernels against their plain versions")
    rows = kernel_checks(ops, ref)

    log("phase 4: granite-3-8b full width, 4 layers, f32: kernels vs plain")
    full_width_check(ops, ref)
    torch.cuda.empty_cache()

    log("phase 5: main path: granite-3-8b, 40 layers, bf16, ServeEngine")
    kernels = ops.kernels()
    launches = main_path(kernels)

    replaces = {"decode_attention": "src/repro/kernels/decode_attention.py:64",
                "flash_attention": "src/repro/kernels/flash_attention.py:79"}
    line = []
    for name in kernels:
        # the bf16 row at the main path's first shape
        r = next(r for r in rows[name] if r["dtype"] == "bfloat16"
                 and "ms" in r)
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
