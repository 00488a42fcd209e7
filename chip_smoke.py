#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each of which raises (exit code != 0) on failure:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and cuDNN.
2. Build: every `src/repro_torch/kernels/csrc/*.cu` with nvcc for sm_90a
   (one nvcc each, in parallel), with registers, spills and static shared
   memory of each attention, va, gemv and scan kernel. The SASS of every ring
   kernel of va and gemv (`csrc/bulk_ring.cuh`) must hold bulk copies
   (UBLKCP: cp.async.bulk). Then `cuobjdump -sass` of the built stream_ops
   library counts the integer adds per element of its k = 128 instance,
   which must be at least 128 (no compiler folded the chain), and the
   pipes they use give the add rate of the bounds (SMs x lanes x
   clocks.max.sm); and the tensor-core flash instantiations must hold
   HMMA instructions.
3. Attention kernels against their plain PyTorch versions, at the serving
   path's shapes and at the reference test sweep's, in f32 and bf16, plus
   rows with no unmasked key (window > 0, q_pos >= Skv + window - 1),
   and chunks whose queries start q_offset positions past the first key
   (FLASH_OFFSET_CASES, f32 and bf16; q_offset = 0 bit-equal to the call
   without it);
   in bf16 also ragged Sq/Skv at hd 64 and 128, hd 16, 48, 72 and 256,
   q/k/v views that are not 16-byte aligned, decode lengths inside the
   first split, on a split boundary and at W not a multiple of the
   split, and two decode launches compared bit for bit. Each row logs
   the route (flash) or the split count (decode) and the grid. Timings of
   the kernel, the plain version and one PyTorch library call
   (scaled_dot_product_attention, a yardstick the port never calls) by
   replaying a CUDA graph of the calls (`graph_ms`: the card's time), and
   of the kernel and the library call launched from Python one after
   another (`launched_ms`: host time included), and the host time of one
   kernel call (`host_us`), beside the least time the card could take
   (`bound_ms`).
4. Full width, 4 layers, f32: granite-3-8b prefill + 8 decode steps through
   the kernels and through the plain versions: every attention call of
   the kernel run also goes through the plain version in f32 and f64 on
   the same activations, and each kernel stays within CALL_TOL of f64 or
   no further from it than the plain f32 version; greedy tokens
   identical; the kernels' logits no further from an f64 run than
   LOGIT_F64_FACTOR times the plain f32 path's. Then full depth in bf16,
   as phase 5 serves it: a 1000-token prefill + 8 decode steps through the
   kernels, every call also through the plain version in bf16 and f64;
   each kernel within TOL of f64 (of the output's scale) or no further
   from it than the plain bf16 version plus CALL_TOL; every prefill on
   the tensor-core route; the first-token logits of the kernel path and
   of the plain bf16 path against an f32 run are logged.
5. The main path: granite-3-8b at full depth and width in bf16, random
   weights from a seed, `ServeEngine(batch_slots=4, max_len=2048)` serving
   8 requests (prompts of 64-1500 tokens, 32 new tokens each) with
   continuous batching. Launch counters must show every attention call
   went through the kernels (40 per decode step and 40 per admission),
   every prefill call on the tensor-core route, and no other kernel ran.
6. The streaming kernels at the paper's sizes, through `kernels.ops` (the
   entry points a user calls; counters zeroed before, read after): va
   (int32) and reduction (f32) at PrIM's n = 2^27, gemv at granite-3-8b's
   unembed and MLP-up shapes (bf16) and PrIM GEMV's (f32). Each output is
   held to its plain version (va bit-exact; reduction within rtol 1e-5 of
   an f64 sum; gemv f32 within 1e-5 of the output's scale of an f64
   product, bf16 within one bf16 rounding of the plain version beyond
   that f32 band (`gemv_check`); va,
   reduction and every gemv bit-identical over two launches). va and gemv
   must have run on their ring routes; each call's route, grid and shared
   memory are logged, and the other routes (va's stride kernel and bulk
   stores, gemv's rows kernel) are held and timed on the same arrays.
   Each kernel is timed beside its bound, its plain version and one
   library call (torch.add, torch.sum, torch.mv): the kernel and the
   library call by CUDA-graph replay (`ms`, `library_ms`: the card's
   time) and launched from Python (`launched_ms`). Then the H100's Fig. 2
   curve: stream_ops on 2^27 int32 at k = 1, 2, 4, ..., 128 (and 256,
   past the knee), each bit-exact against the plain version, with Gop/s,
   GB/s and the bound of each point; past the knee the time must grow
   with k. Edge cases (ragged tails, unaligned views, n and M below one
   ring stage, K beyond one stage, other dtypes, other k) are checked at
   small sizes and must reach every route of va and gemv.
7. The Fig. 2 entry point, `python -m repro_torch.benchmarks.run
   microbench` (its `main`, in process) on the card: it must pass, and the
   counters must show its sweep (k = 1, 4, 16) went through the stream_ops
   kernel and nothing else.
8. The PrIM bank-local kernels at PrIM's sizes, through `kernels.ops`
   (counters zeroed before, read after): `ops.scan` on 2^27 int32 in
   [-100, 100) with the f32 accumulator (one scan_blocks and one
   add_offsets launch) and on the int32 route (one scan_lookback launch),
   `ops.histogram`
   on 2^26 uint32 < 2^12 at 256 and 4096 bins (HST-S, HST-L: two
   histogram launches), `ops.ts_min` on a 2^26 int32 series with m = 8
   (one ts_dists launch), `ops.transpose` of 8192 x 8192 int32 (one
   transpose launch). Each result is held to its plain version on the same
   tensors: scan, histogram, ts distances and transpose bit-exact, the ts
   index equal to the plain argmin. Edge cases at small sizes: ragged and
   unaligned lengths, n < 128, f32 scan data (within 1e-5 of max |prefix|
   of an f64 cumsum and no further than the plain version), out-of-range
   histogram values (dropped), a planted ts tie (first index), one window
   (m = n), m = 512, a query longer than the series ((inf, 0) with no
   launch), 8191 x 8193. Then each kernel is timed beside its
   bound, its plain version and one library call (torch.cumsum for the
   whole scan, the broadcast add, torch.histc, A.t().contiguous(); none
   for ts), by CUDA-graph replay and launched, as in phase 6.
9. Every PrIM workload's `run_pim` (`repro_torch.prim`, the 16 names of
   the registry) on the card, on a `BankGrid` of one bank at the
   workload's REF_N (NW at NW_CARD_N: its `ref` is a cell-by-cell loop on
   the host; the cut is printed), then on 8 banks at 2^20 elements (GEMV,
   MLP, NW, BFS and TRNS at the sizes of tests/test_prim_multibank.py), so
   that the exchanges run on the card too. Each result is held to the
   port's `ref` on the same tensors: as the same bits, SpMV within 1e-5 of
   each row's sum of |products|. Counters are zeroed before each workload
   and read after: VA, GEMV, MLP, RED, SCAN-SSA, SCAN-RSS, HST-S, HST-L,
   TS and TRNS must launch exactly their kernels (gemv, reduction,
   add_offsets and the single-pass scan_lookback all on their int32
   routes), the others none. Each workload's run and its `ref` are timed
   on the host clock (median of 5, host included). Then the single-pass
   scan is held bit-exact to its plain version and to torch.cumsum(x, 0,
   dtype=torch.int32) (plus the carry) with carries 0, 2^31 - 1 and -2^31,
   on data whose sums wrap, at n = 1, 31, one tile - 1, one tile, one tile
   + 1, 2^20 + 3 and 2^27 + 5, on unaligned views, on three replays of a
   CUDA graph of it, and over STRESS_LAUNCHES back-to-back launches on two
   streams. Then the int32 routes (reduction, the scan pair, the whole
   int32 `ops.scan` on the single-pass kernel and as the pair, gemv at
   PrIM GEMV's and MLP's shapes) are held bit-exact to their plain
   versions and timed by graph replay beside their bounds and beside
   torch.sum(x, dtype=torch.int32) and torch.cumsum(x, 0,
   dtype=torch.int32) (gemv has no int32 library call).
10. The PrIM entry point, `python -m repro_torch.benchmarks.run
   prim_bench` (its `main`, in process) on the card: it must pass, its
   launches must be Table I's (one bank each), and the four Fig. 4 anchors
   of the model must equal the reference's model numbers (FIG4_ANCHORS).
11. MoE on the card, qwen2-moe-a2.7b (60 routed experts top-4, 4 shared
   behind a sigmoid gate). (a) Full width, 2 layers, f32: a MOE_PROMPT-
   token prefill and 8 greedy decode steps through the kernels and through
   the plain versions: greedy tokens identical, the kernels' logits no
   further from an f64 run of the plain path (teacher-forced) than the
   plain f32 path's (P1's form); the expert choices that differ between
   the runs are counted and logged. The same prefill with int8 experts
   (quantized in the forward): its first-token logits must differ from
   the f32 ones, by less than 0.05 of their scale (tests/test_quant.py's
   gate), and, against the same int8 and f32 prefills run on the CPU on
   the same weights, must lie at most INT8_CPU_SHARE as far from the CPU's
   int8 logits as int8 moves the CPU's logits. (b) On layer 0's real
   prefill and
   decode dispatch buffers of that run: `quantize_q8` on the card
   bit-identical to the CPU's on the layer's experts, and the int8 expert
   FFN's three contractions (torch._int_mm, one per expert, int32
   accumulators) bit-exact to an int64 contraction of the same int8
   operands on the CPU; shapes outside torch._int_mm's limits raise. (c)
   Full width and depth (24 layers), bf16, phase 5's workload served
   twice, with bf16 experts and with quant="int8" (experts quantized once
   by the engine): exactly 24 decode-attention launches a decode step and
   24 flash launches an admission, every prefill on the tensor-core route,
   no other kernel; the expert contractions counted on their route (bf16:
   3 batched float products a layer and forward, none int8; int8: 3 x 60
   torch._int_mm a layer and forward, none float). TTFT, ms/step, weight
   bytes and peak memory of both serves; the int8 serve's first-token
   logits against the bf16 serve's and the share of identical greedy
   tokens are logged.
12. Sliding window on the card. REDUCED starcoder2-7b and mixtral-8x7b,
   f32, max_len 32 (a ring of 16): the 16-step wrapping schedule of
   tests/test_serve.py through the kernels and through the plain versions
   gives the same tokens, with the attention launches of the path. Then
   starcoder2-7b at full width, bf16: one SWA_PROMPT-token prompt (past
   its 4096 window) and 16 decode steps at max_len SWA_MAX_LEN (a 4096
   ring), every attention call held to the plain version in bf16 and f64
   in P5's scale-relative form (as phase 4's bf16 run), every prefill on
   the tensor-core route.
13. The program census (`core.census`) on the card's programs. (a) The
   suitability entry point, `python -m repro_torch.benchmarks.run
   suitability_bench` (its `main`, in process), with its inputs and
   parameters on the card: it must pass, launch no kernel, and print the
   reference's verdicts (SUITABILITY_VERDICTS) for the nine PrIM rows and
   the two LM steps. (b) The census of granite-3-8b's decode step as
   phase 5's engine runs it (40 layers, bf16, 4 slots x 2048, positions
   per slot), on parameters made under FakeTensorMode: its FLOPs, bytes
   and OI, scored on the modelled TPU v5e and UPMEM machines; it must be
   memory-bound on the TPU. Its bytes over what the card moves at
   HBM_BYTES_PER_S in phase 5's measured decode ms/step is the step's
   share of its memory roof, which must not exceed ROOF_SHARE_MAX. The
   same for qwen2-moe-a2.7b's bf16 decode step against phase 11's ms/step.
14. The planner-routed path (`repro_torch.dispatch`,
   `ServeEngine(engine="dispatch")`) on the card. (a) `runtime.execute`
   of `mixed_pipeline(m=DISPATCH_MIXED_M)` (int32) under the planner's
   hybrid plan and all-PIM at 1 and MULTIBANK banks: bit-exact to
   `runtime.reference`, the only launches the transpose kernel's, one per
   PIM `trns` stage; the decode chain's int32 attention contraction on
   the card (`workloads._int_einsum`) bit-exact to the CPU's int32 einsum,
   and `decode_pipeline(REDUCED_DIMS)` all-PIM on 2 banks validated by
   `runtime.execute`. (b) granite-3-8b at full width, 4 layers, f32: four
   requests through the fused engine, through the dispatch engine with
   the planner's plans (one prefill chunk a prompt) and with all-PIM
   decode at 4 banks: greedy tokens identical and every decode step's
   logits the fused engine's bits; then prefill in DISPATCH_F32_CHUNK-
   token chunks (the flash kernel with q_offset) in P1's form, every
   attention call held to its plain version in f32 and f64, and the
   first-token logits within DISPATCH_F32_PREFILL_REL of their scale of
   the fused whole-prompt prefill's. (c) granite-3-8b at full width and depth, bf16, phase
   5's workload through the dispatch engine, with the planner's plans and
   with every stage on the PIM device at 4 banks: exactly 40 decode-
   attention launches a step and 40 flash launches a prefill chunk, all
   on the tensor-core route, no other kernel, the two serves' tokens
   equal; planning (engine build) seconds, ms/step, TTFT and peak memory
   beside phase 5's, the FaceCache stats and host-face fallbacks logged;
   then phase 4's bf16 form on the dispatch path (a BF16_PROMPT-token
   prompt in chunks and 8 decode steps, every attention call held to its
   plain version in bf16 and f64). (d) REDUCED mixtral-8x7b (int8
   experts, expert_shards=2 on two ranks; its int8 contraction at K = 64,
   padded to 128, bit-exact to int64) and starcoder2-7b (banded prefill,
   22-token prompts in 4-token chunks), f32, max_len 32: dispatch tokens
   identical to the fused engine's on the card.
15. The serving gateway (`repro_torch.serve.gateway`) on the card. (a)
   gateway_bench's full-width workload (`full_width_gateway`, the same
   that `gateway_bench` serves on the card): granite-3-8b at full width
   and depth (bf16, phase 5's engine: 4 slots x 2048, SEED weights)
   behind `Gateway`, 16 seeded Poisson arrivals of 32 new tokens with
   prompts of 64-1500 tokens at half the rate that the warmed engine's
   measured admission and step times sustain, written with
   `save_arrival_trace` and read back with `load_arrival_trace`; the plan
   cache prewarmed (timed) over the whole envelope; every request done,
   no plan solved in band, exactly one decode-attention launch a layer
   and decode step and one flash launch (tensor-core route) a layer and
   admission; `GatewayStats.rows()` and one `{"gateway": {...}}` JSON
   line (sustained and goodput req/s, TTFT and ITL p50/p99, tokens/s,
   decode steps, prewarm seconds, the card's name and power limit). (b)
   GATEWAY_PAIR_REQUESTS requests with prompts within one prefill chunk
   through a gateway over the fused engine and one over
   `engine="dispatch"` (full width, GATEWAY_PAIR_LAYERS layers, f32, one
   set of weights), each under its own `ManualClock(tick=1e-3)`: the same
   decisions, stats, plan-cache keys and tokens; the planner-fidelity gate
   on the dispatch run's traced decode timeline. (c) `python -m
   repro_torch.benchmarks.run gateway_bench --quick --trace <tmp>`,
   `dispatch_bench --quick` and `scaling_bench`, in process: each exits 0
   (its gates held); only gateway_bench launches kernels (attention).

The second-to-last line is the `kernels` JSON: each kernel's `launches`
are those of the phase that drives it (5 for the attention kernels, 6
for va, reduction and gemv, 7 for stream_ops, 8 for the PrIM bank-local
kernels, scan_lookback included), its `prim_launches` those of phases 9
and 10 together, and its `moe_swa_launches` those of the counted runs of
phases 11 and 12 (the two qwen2-moe serves, the kernel runs of the
wrapping schedules and starcoder2-7b's full-width run), and its
`dispatch_launches` those of phase 14's counted runs, and its
`gateway_launches` those of phase 15. The last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import re
import statistics
import subprocess
import sys
import time
import zlib
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# H100 SXM data sheet: HBM3 bandwidth and dense peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Hopper architecture white paper: 64 INT32 lanes per SM (16 per SM
# sub-partition). With the SM count and the SM clock (nvidia-smi
# clocks.max.sm) this gives the card's INT32 add rate (phase 2).
INT32_LANES_PER_SM = 64
# an add the compiler issues as VIADD or IMAD.IADD can run beside the
# INT32 pipe; the SM then issues at most 4 warp instructions a clock:
# 128 lanes
ISSUE_LANES_PER_SM = 128
PRIM_N = 1 << 27            # REF_N of prim/va.py and prim/red.py
# the paper's k axis (fig2_rows), plus k = 256 so that the curve shows two
# points past the card's knee
FIG2_K = (1, 2, 4, 8, 16, 32, 64, 128, 256)
STREAM_ROW_K = 16           # the `kernels` line's stream_ops point
# (M, K, dtype, what): granite-3-8b unembed (vocab padded) and MLP up, then
# PrIM GEMV's reference shape (prim/gemv.py)
GEMV_CASES = [(49280, 4096, torch.bfloat16, "granite-3-8b unembed"),
              (12800, 4096, torch.bfloat16, "granite-3-8b MLP up"),
              (8192, 2048, torch.float32, "PrIM GEMV")]
# of max |f64 product|: gemv f32's band against f64, and the band by which
# two f32 sums of a bf16 row may differ before they round to bf16
GEMV_F32_TOL = 1e-5
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
# bf16 full-depth check (phase 4): one prompt of a length inside phase 5's
# 64-1500 and no multiple of the flash kernels' 64-row tiles
BF16_PROMPT = 1000
# phase 8: PrIM's sizes (REF_N of prim/scan_ssa.py, hst.py, ts.py, trns.py)
PRIM_SCAN_N = 1 << 27
PRIM_HST_N = 1 << 26
HST_BINS = (256, 4096)      # HST-S, HST-L
PRIM_TS_N, TS_M = 1 << 26, 8
PRIM_TRNS = 8192            # 8192 x 8192
# f32 scan: largest error against an f64 cumsum, as a share of max |prefix|
# (the band tests/test_torch_prim_kernels.py holds the plain scan to)
SCAN_F32_TOL = 1e-5
# phase 9: NW's `ref` is a cell-by-cell loop on the host, so NW runs at
# this n, not its REF_N (4096); every other workload at its REF_N
NW_CARD_N = 1024
MULTIBANK = 8
# phase 9: back-to-back launches of the single-pass scan over 2^22 elements
# (512 tiles), alternating between two streams, each result compared
STRESS_LAUNCHES = 400
STRESS_N = 1 << 22
MULTIBANK_N = 1 << 20
# tests/test_prim_multibank.py's sizes; TRNS at 1024 x 1024 = 2^20
MULTIBANK_SIZES = {"NW": 128, "MLP": 256, "BFS": 256, "GEMV": 512,
                   "TRNS": 1024}
# the reference's Fig. 4 anchors (repro.core.perf_model over
# repro.prim.all_ref_counts(); tests/test_torch_perf_model.py holds these
# constants to it): modelled UPMEM / Xeon / Titan V numbers, not the card's
FIG4_ANCHORS = {"avg_speedup_2556_vs_cpu": 24.055134942052366,
                "avg_speedup_640_vs_cpu": 8.778363442742867,
                "avg_speedup_2556_vs_gpu_suitable": 2.548827864194352,
                "avg_energy_eff_640_vs_cpu": 1.519332134320881}
FIG4_REL = 1e-12
# phase 11: the 2-layer f32 check's prompt; phase 12: starcoder2-7b's
# prompt, past its 4096-token window, and the cache length (a 4096 ring)
MOE_PROMPT = 300
# phase 11 (a): int8 experts move the 2-layer first-token logits by ~4e-4
# of their scale (measured on the H100); the card's int8 logits must lie
# no further than this share of that from the CPU's int8 logits on the
# same weights. The integers are the same on both (the contractions are
# exact, quantization bit-identical); what differs is f32 rounding outside
# them and the rare re-quantized element it moves by one step.
INT8_CPU_SHARE = 0.5
INT8_LOGIT_GATE = 0.05      # tests/test_quant.py: 0 < |int8 - f32| < 0.05
SWA_PROMPT = 4200
SWA_MAX_LEN = 4608
# phase 13: the reference's suitability verdicts (repro.core.suitability
# on analyze_hlo, as benchmarks/suitability_bench.py scores them;
# tests/test_torch_suitability.py holds these constants to it). PrIM rows
# at n = 4096 on the modelled UPMEM system: (KT1 memory-bound, KT2 simple
# ops, KT3 low communication, PIM-suitable); LM steps of REDUCED
# granite-3-8b: memory-bound on the modelled TPU v5e. The reference's
# train row comes with the port of train/.
SUITABILITY_VERDICTS = {
    "VA": (True, True, True, True),
    "GEMV": (True, True, True, True),
    "SpMV": (True, True, True, True),
    "BS": (True, True, True, True),
    "RED": (True, True, True, True),
    "SCAN-SSA": (True, True, True, True),
    "TRNS": (False, True, True, False),
    "TS": (True, True, True, True),
    "HST-S": (True, False, True, False),
    "prefill": True,
    "decode": True,
}
# phase 13: census bytes of a decode step over what the card can move in
# its measured ms/step; above this the census would count bytes the step
# cannot have moved
ROOF_SHARE_MAX = 1.05
CENSUS_SLOTS, CENSUS_MAX_LEN = 4, 2048      # phase 5's engine
# phase 14: the mixed PrIM pipeline at the shipped graph's size; the f32
# dispatch prefill's chunk (prompts of 1-3 chunks)
DISPATCH_MIXED_M = 4096
DISPATCH_F32_CHUNK = 128
# the chunked f32 prefill's first-token logits against the fused
# whole-prompt prefill's, as a share of their scale over the real vocab:
# on an H100 (700 W) the four prompts read 1.55e-3, 4.7e-4, 5.1e-4 and 0
# (one chunk); wrong K/V rows or positions move them by far more
DISPATCH_F32_PREFILL_REL = 3e-3
# DispatchPrefillStep's default planning horizon, in chunks
PREFILL_PLANNED = 4
# bytes a dropped dispatch engine may leave allocated (its weights and
# cache are 16.7 GB)
LEFT_AFTER_DROP = 1 << 30
# phase 15 (b): fused and dispatch gateways under one virtual clock, on
# phase 14 (b)'s model (full width, 4 layers, f32); prompts within one
# 512-token prefill chunk
GATEWAY_PAIR_LAYERS = 4
GATEWAY_PAIR_REQUESTS = 6

# (B, H, KVH, hd, W, lengths): the path's shape, then tests/test_kernels.py's
DECODE_CASES = [
    (4, 32, 8, 128, 2048, [1, 511, 1300, 2048]),
    (2, 8, 2, 64, 1000, 777),
    (1, 4, 4, 128, 512, 512),
    (2, 16, 2, 64, 2048, 1),
    # the kernel's limits: 16 query heads per KV head at hd 256; hd 8
    (2, 32, 2, 256, 300, [5, 300]),
    (1, 2, 1, 8, 50, 50),
]
# bf16 only: the tensor-core route's edges (ragged Sq/Skv at hd 64 and
# 128, hd 16 of the REDUCED configs, 48 and 256) and one bf16 head dim that
# is no multiple of 16 (72: the CUDA-core route)
FLASH_BF16_CASES = [
    (333, 333, 8, 2, 64, True, 0),
    (200, 457, 8, 4, 128, False, 0),
    (300, 700, 8, 2, 128, True, 100),
    (64, 64, 4, 1, 16, True, 0),
    (100, 77, 4, 4, 48, False, 0),
    (130, 130, 4, 2, 256, True, 0),
    (100, 100, 4, 2, 72, True, 0),
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
    # rows with no unmasked key: q_pos >= Skv + window - 1
    (40, 16, 4, 2, 64, True, 4),
    (300, 100, 4, 2, 128, False, 32),
]
# (Sq, Skv, H, KVH, hd, window, q_offset), causal: a chunk of a chunked
# prefill whose queries sit q_offset positions past the first key (phase
# 14's path): the fourth 512-token chunk of a 2048-token prompt, a banded
# prefix whose keys start past 0, a window with an offset (key tiles
# wholly dead), rows with no key, and no row with a key
FLASH_OFFSET_CASES = [
    (512, 2048, 32, 8, 128, 0, 1536),
    (300, 700, 8, 2, 128, 500, 400),
    (256, 1024, 4, 2, 64, 64, 768),
    (100, 64, 4, 2, 64, 16, 60),
    (32, 16, 2, 2, 64, 4, 40),
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


def graph_ms(fn, arg_sets, reps: int = 7, per_rep: int = 10) -> float:
    """Like median_ms, but the `per_rep` calls are captured once in a CUDA
    graph and replayed: the card's time for the work, without the host's
    launch gaps (a decode-attention call takes less time on the card than
    its Python wrapper takes to launch it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*arg_sets[0])                 # warm up off the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for i in range(per_rep):
                fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    del graph
    return statistics.median(times)


def host_us(fn, args, n: int = 100) -> float:
    """Host time (microseconds) of one call: `n` calls timed on the host
    clock up to the last enqueue, the card left to catch up afterwards.
    This is what a call costs a host-bound step (the wrapper, its checks
    and allocations, its launches), apart from the card's time."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def card_times(kernel, plain, library, sets, plain_reps=7,
               plain_per_rep=10) -> dict:
    """`ms` and `library_ms` by graph replay (the card's time), and both
    launched from Python one after another (`launched_ms`,
    `library_launched_ms`: host time included); `plain_ms` launched (the
    plain version is no yardstick of speed). `library` None: no call."""
    out = {"ms": graph_ms(kernel, sets),
           "launched_ms": median_ms(kernel, sets),
           "plain_ms": median_ms(plain, sets, plain_reps, plain_per_rep),
           "library_ms": None}
    if library is not None:
        out["library_ms"] = graph_ms(library, sets)
        out["library_launched_ms"] = median_ms(library, sets)
    return out


def bound(nbytes: float, ops_: float, rate: float) -> tuple[float, str]:
    """The least time (ms) for moving `nbytes` through HBM and doing `ops_`
    operations at `rate` per second, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


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
    from repro_torch.kernels import decode_attention as kda
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
    got = ops.decode_attention(q, k, v, lengths)
    err = check_close("decode_attention", dtype, got,
                      ref.decode_attention(q, k, v, lens))
    if not torch.equal(got, ops.decode_attention(q, k, v, lengths)):
        raise AssertionError(f"decode_attention {case} {dtype}: two launches "
                             f"gave different bits")
    splits = kda.splits_for(b, kvh, w, q.get_device())
    row = {"case": f"B{b} H{h} KVH{kvh} hd{hd} W{w} len{lengths}",
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "splits": splits, "chunk": -(-w // splits),
           "grid": f"{b}x{kvh}x{splits}={b * kvh * splits}",
           "bit_identical_twice": True}
    if not timed:
        return row
    isz = torch.finfo(dtype).bits // 8
    n_rows = int(lens.sum())
    nbytes = (n_rows * kvh * hd * 2 + 2 * b * h * hd) * isz + 4 * b
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4.0 * n_rows * h * hd,
                                             PEAK_FLOPS[dtype])
    kernel = lambda q, k, v: ops.decode_attention(q, k, v, lens)
    row["ms"] = graph_ms(kernel, sets)
    row["plain_ms"] = graph_ms(
        lambda q, k, v: ref.decode_attention(q, k, v, lens), sets)
    mask = (torch.arange(w, device=dev)[None, :] < lens[:, None])[:, None, None]

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    row["library_ms"] = graph_ms(library, sets)
    # launched from Python one after another, host time included
    row["launched_ms"] = median_ms(kernel, sets)
    row["library_launched_ms"] = median_ms(library, sets)
    row["host_us"] = host_us(kernel, sets[0])
    return row


def decode_split_cases():
    """bf16 decode at the lengths where the split kernel changes hands:
    inside the first split, on a split boundary and one past it, and at W;
    at the path's shape and at a W that is no multiple of the split."""
    from repro_torch.kernels import decode_attention as kda
    dev = torch.cuda.current_device()
    b, h, kvh, hd, w = 4, 32, 8, 128, 2048
    chunk = -(-w // kda.splits_for(b, kvh, w, dev))
    cases = [(b, h, kvh, hd, w, [chunk // 2, chunk, chunk + 1, w])]
    b, h, kvh, hd, w = 2, 16, 4, 128, 1000
    chunk = -(-w // kda.splits_for(b, kvh, w, dev))
    if w % chunk == 0:
        raise AssertionError(f"decode W {w} is a multiple of its split "
                             f"{chunk}: pick another W")
    return cases + [(b, h, kvh, hd, w, [chunk + 1, w])]


def flash_case(ops, ref, case, dtype, gen, timed, misaligned=False,
               q_offset=0):
    from repro_torch.kernels import flash_attention as kfa
    sq, skv, h, kvh, hd, causal, window = case
    dev = "cuda"
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    batch = 2 if misaligned else 1
    if misaligned:
        # hd-wide views 4 elements into rows of hd + 8: no 16-byte copies
        sets = [tuple(mk(batch, n, nh, hd + 8)[..., 4:4 + hd]
                      for n, nh in ((sq, h), (skv, kvh), (skv, kvh)))]
    else:
        sets = [(mk(1, sq, h, hd), mk(1, skv, kvh, hd), mk(1, skv, kvh, hd))
                for _ in range(4 if timed else 1)]
    q, k, v = sets[0]
    got = ops.flash_attention(q, k, v, causal, window, q_offset)
    err = check_close("flash_attention", dtype, got,
                      ref.flash_attention(q, k, v, causal, window, q_offset))
    if not q_offset and not torch.equal(got, ops.flash_attention(
            q, k, v, causal, window)):
        raise AssertionError(f"flash_attention {case}: q_offset=0 and the "
                             f"call without it disagree")
    if misaligned and not torch.equal(got, ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, window)):
        raise AssertionError(f"flash_attention {case}: unaligned views and "
                             f"their contiguous copies disagree")
    row = {"case": f"Sq{sq} Skv{skv} H{h} KVH{kvh} hd{hd} causal{int(causal)} "
                   f"window{window}" + (" unaligned views" if misaligned else "")
                   + (f" q_offset{q_offset}" if q_offset else ""),
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "batch": batch, "route": kfa.route(dtype, hd),
           "grid": f"{-(-sq // 64)}x{h}x{batch}={-(-sq // 64) * h * batch}"}
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
                                             PEAK_FLOPS[dtype])
    kernel = lambda q, k, v: ops.flash_attention(q, k, v, causal, window)
    row["ms"] = graph_ms(kernel, sets)
    row["plain_ms"] = graph_ms(
        lambda q, k, v: ref.flash_attention(q, k, v, causal, window), sets,
        reps=5, per_rep=4)
    lib_mask = None if (causal and not window and sq == skv) \
        else mask.to(dev)

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=lib_mask, is_causal=lib_mask is None, enable_gqa=True)
    row["library_ms"] = graph_ms(library, sets)
    row["launched_ms"] = median_ms(kernel, sets)
    row["library_launched_ms"] = median_ms(library, sets)
    row["host_us"] = host_us(kernel, sets[0])
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
                flash_case(ops, ref, case, dtype, gen, timed=i <= 2))
    bf16 = torch.bfloat16
    for case in decode_split_cases():
        rows["decode_attention"].append(
            decode_case(ops, ref, case, bf16, gen, timed=False))
    for case in FLASH_BF16_CASES:
        rows["flash_attention"].append(
            flash_case(ops, ref, case, bf16, gen, timed=False))
    for case in ((150, 150, 4, 2, 128, True, 0), (97, 130, 4, 4, 64, False, 40)):
        rows["flash_attention"].append(
            flash_case(ops, ref, case, bf16, gen, timed=False, misaligned=True))
    for dtype in (torch.float32, bf16):
        for sq, skv, h, kvh, hd, window, off in FLASH_OFFSET_CASES:
            rows["flash_attention"].append(
                flash_case(ops, ref, (sq, skv, h, kvh, hd, True, window),
                           dtype, gen, timed=False, q_offset=off))
    torch.cuda.synchronize()
    for name, rs in rows.items():
        for r in rs:
            log(f"  {name} {r['dtype']:8s} {r['case']}: " + ", ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items() if k not in ("case", "dtype")))
    path = rows["decode_attention"][len(DECODE_CASES)]   # bf16, path shape
    b, _, kvh, _, _, _ = DECODE_CASES[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if not b * kvh * path["splits"] > sms:
        raise AssertionError(f"decode at the path's shape runs {path['grid']} "
                             f"blocks, not more than the card's {sms} SMs")
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
    the plain version in the model's dtype and in f64 on the same
    activations. `worst` collects, per kernel, the largest max|x - y| /
    max|f64| over the calls for x, y = kernel and plain, kernel and f64,
    plain and f64, and how many output elements lay outside phase 3's
    band |kernel - plain| <= TOL (1 + |plain|) (f32 or bf16)."""
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
            band = TOL[(name, got.dtype)] * (1 + want.double().abs())
            w["outside band"] = w.get("outside band", 0) + int(
                ((got.double() - want.double()).abs() > band).sum())
            w["elements"] = w.get("elements", 0) + got.numel()
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


def greedy_run(cfg, params, prompt, max_len, steps=8, forced=None):
    """Prefill `prompt` (1, S), then `steps` greedy decode steps (or steps
    on the `forced` tokens). Returns the tokens and the logits of every
    step, (steps + 1, vocab) in f64."""
    from repro_torch.models import forward, init_cache
    cache = init_cache(cfg, 1, max_len, "cuda")
    logits, cache, _ = forward(params, cfg, tokens=prompt, cache=cache)
    outs, toks = [logits[:, -1]], []
    for i in range(steps):
        tok = outs[-1].argmax(-1) if forced is None else torch.tensor(
            [forced[i]], device="cuda")
        toks.append(int(tok))
        logits, cache, _ = forward(params, cfg, tokens=tok[:, None],
                                   cache=cache)
        outs.append(logits[:, -1])
    return toks, torch.stack(outs)[..., :cfg.vocab_size].double()


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def log_worst(worst, limit):
    for name, w in worst.items():
        log(f"  {name} calls, worst max |x - y| / max |f64|: "
            + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in w.items()) + limit)


def full_width_check(ops, ref):
    """Prefill + 8 greedy decode steps through the kernels (each call held
    to its plain version), through the plain versions, and (teacher-forced
    on the kernels' tokens) through the plain versions in f64 with f64
    weights."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import init_params, tree_map

    cfg = dataclasses.replace(get_arch("granite-3-8b"), n_layers=4,
                              dtype="float32")
    params = init_params(SEED, cfg, "cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg.vocab_size, (1, 300), generator=gen)
    prompt = prompt.to("cuda")

    def run(cfg, params, forced=None):
        return greedy_run(cfg, params, prompt, 512, forced=forced)

    worst = {}
    kfa.KERNEL.reset()
    with torch.no_grad():
        with checked_attention(ops, ref, worst):
            toks_k, lg_k = run(cfg, params)
        routes = {r: kfa.KERNEL.route_launches[r] for r in kfa.ROUTES}
        if routes["tensor_core"] or not routes["cuda_core"]:
            raise AssertionError(f"full-width f32: flash routes {routes}, "
                                 f"want CUDA cores only")
        with plain_attention(ops, ref):
            toks_p, lg_p = run(cfg, params)
            params = tree_map(lambda t: t.double(), params)
            _, lg_64 = run(dataclasses.replace(cfg, dtype="float64"), params,
                           forced=toks_k)
    err_k, err_p = rel(lg_k, lg_64), rel(lg_p, lg_64)
    log_worst(worst, f" (kernel-f64 limit: {CALL_TOL} or plain-f64)")
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


def full_width_bf16_check(ops, ref):
    """granite-3-8b as phase 5 serves it (40 layers, bf16, the same random
    weights): prefill of one BF16_PROMPT-token prompt and 8 greedy decode
    steps through the kernels, every attention call run through the plain
    version in bf16 and in f64 on the model's own activations, whose
    scores are in the hundreds, far from phase 3's random ones. As the f32
    check does, per kernel the worst max |kernel - f64| / max |f64| over
    the calls must be within TOL, or no larger than the plain bf16
    version's worst plus CALL_TOL (the f32 allowance for these scores).
    Phase 3's element-wise band is only logged here: on these activations
    the plain version itself leaves decode's band of f64, where an output
    in the tens lies near a bf16 rounding midpoint and kernel and plain
    version round it an ulp (0.0625-0.25) apart (measured on the H100, for
    the PR 13 kernels too). Then the prompt's first-token logits through
    the plain versions in bf16 and in f32 (f32 weights): how far each bf16
    path lies from f32 is logged, not bounded, since random weights at 40
    layers amplify any rounding."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import init_params, tree_map

    cfg = get_arch("granite-3-8b")
    params = init_params(SEED, cfg, "cuda")
    gen = torch.Generator().manual_seed(SEED + 3)
    prompt = torch.randint(0, cfg.vocab_size, (1, BF16_PROMPT), generator=gen)
    prompt = prompt.to("cuda")
    max_len = BF16_PROMPT + 24

    worst = {}
    kfa.KERNEL.reset()
    with torch.no_grad():
        with checked_attention(ops, ref, worst):
            toks_k, lg_k = greedy_run(cfg, params, prompt, max_len)
        routes = {r: kfa.KERNEL.route_launches[r] for r in kfa.ROUTES}
        with plain_attention(ops, ref):
            _, lg_p = greedy_run(cfg, params, prompt, max_len, steps=0)
            params = tree_map(lambda t: t.float(), params)
            _, lg_32 = greedy_run(dataclasses.replace(cfg, dtype="float32"),
                                  params, prompt, max_len, steps=0)
    del params
    log_worst(worst, f" (kernel-f64 limit: TOL or plain-f64 + {CALL_TOL})")
    first = lg_k[0]
    log(f"  tokens kernels {toks_k}")
    log(f"  first-token logits max rel diff vs f32: kernels "
        f"{rel(first, lg_32[0]):.4g}, plain bf16 {rel(lg_p[0], lg_32[0]):.4g}"
        f"; kernels vs plain bf16 {rel(first, lg_p[0]):.4g}; argmax kernels "
        f"{int(first.argmax())}, plain bf16 {int(lg_p[0].argmax())}, f32 "
        f"{int(lg_32[0].argmax())}")
    want_routes = {"cuda_core": 0, "tensor_core": cfg.n_layers}
    if routes != want_routes:
        raise AssertionError(f"full-width bf16: flash routes {routes}, want "
                             f"{want_routes}")
    if sorted(worst) != ["decode_attention", "flash_attention"]:
        raise AssertionError(f"full-width bf16: attention calls seen {worst}")
    for name, w in worst.items():
        limit = max(TOL[(name, torch.bfloat16)], w["plain-f64"] + CALL_TOL)
        if not w["kernel-f64"] <= limit:
            raise AssertionError(f"full-width bf16: {name} kernel is "
                                 f"{w['kernel-f64']:.3g} of the output's "
                                 f"scale from f64, the plain version "
                                 f"{w['plain-f64']:.3g} (limit {limit:.3g})")
    if not torch.isfinite(lg_k).all():
        raise AssertionError("full-width bf16: kernel logits not finite")


# --------------------------------------------------------------------- #
# phase 5: the main path
# --------------------------------------------------------------------- #

def serve_workload(arch: str = "granite-3-8b", **engine_kwargs):
    """Phase 5's workload: `arch` (granite-3-8b; phase 11 serves
    qwen2-moe-a2.7b) at full width and depth, random weights from SEED,
    a ServeEngine of 4 slots x 2048 tokens (`engine_kwargs` added: phase
    14 serves through `engine="dispatch"`), and 8 seeded requests with
    prompts of 64-1500 tokens and 32 new tokens each.
    Returns (cfg, params, engine, requests)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = get_arch(arch)
    if arch == "granite-3-8b":
        assert cfg.n_layers == SERVE_LAYERS
    params = init_params(SEED, cfg, "cuda")
    engine = ServeEngine(cfg, params, batch_slots=4, max_len=2048,
                         seed=SEED, device="cuda", **engine_kwargs)
    gen = torch.Generator().manual_seed(SEED + 1)
    lens = torch.randint(64, 1501, (8,), generator=gen).tolist()
    reqs = [Request(i, torch.randint(0, cfg.vocab_size, (n,), generator=gen),
                    32) for i, n in enumerate(lens)]
    return cfg, params, engine, reqs


def serve(engine, reqs):
    """Serve `reqs` on `engine`. Returns the finished requests by id and
    the serving metrics: wall s, prefill ms per admission, decode ms/step,
    decode tokens/s, TTFT ms per request (host clock from the start of
    the serve), the first 8 tokens of each request."""
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = sorted(done, key=lambda r: r.rid)
    decode_tokens = sum(len(r.out_tokens) - 1 for r in done)
    return done, {
        "wall_s": wall,
        "prefill_ms": engine.prefill_s / engine.n_prefills * 1e3,
        "decode_ms_per_step": engine.decode_s * 1e3 / engine.n_decode_steps,
        "decode_tokens_per_s": decode_tokens / engine.decode_s,
        "ttft_ms": [(r.first_token_at - t0) * 1e3 for r in done],
        "tokens": [r.out_tokens[:8] for r in done],
        "tokens_all": [list(r.out_tokens) for r in done]}


def main_path(kernels):
    """Phase 5. Returns the serving metrics of `serve` and the launches of
    every kernel in the run."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import tree_map

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, engine, reqs = serve_workload()
    torch.cuda.synchronize()
    leaves = []
    tree_map(leaves.append, params)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"  init_params and engine {time.perf_counter() - t0:.2f}s: "
        f"{sum(t.numel() for t in leaves)} parameters, {weight_bytes} bytes")

    for k in kernels.values():
        k.reset()
    done, metrics = serve(engine, reqs)
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {r: kfa.KERNEL.route_launches[r] for r in kfa.ROUTES}

    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in done:
        if len(r.out_tokens) != r.max_new_tokens:
            raise AssertionError(f"req {r.rid}: {len(r.out_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"req {r.rid}: vocab-padding token")
    want = {name: 0 for name in kernels}
    want.update(decode_attention=SERVE_LAYERS * engine.n_decode_steps,
                flash_attention=SERVE_LAYERS * engine.n_prefills)
    log(f"  launches {launches}, expected {want} ({engine.n_decode_steps} "
        f"decode steps, {engine.n_prefills} admissions)")
    if launches != want or engine.n_prefills != len(reqs):
        raise AssertionError("launch counts do not match the path")
    want_routes = {"tensor_core": want["flash_attention"], "cuda_core": 0}
    log(f"  flash_attention launches by route {routes}, expected "
        f"{want_routes}")
    if routes != want_routes:
        raise AssertionError("bf16 prefill did not take the tensor-core route")

    for r, ttft, toks in zip(done, metrics["ttft_ms"], metrics["tokens"]):
        log(f"  req {r.rid}: prompt {len(r.prompt)}, TTFT {ttft:.1f} ms, "
            f"tokens {toks}...")
    log(f"  serve wall {metrics['wall_s']:.3f}s; prefill "
        f"{engine.prefill_s:.3f}s over {engine.n_prefills} admissions "
        f"({metrics['prefill_ms']:.1f} ms each); decode "
        f"{metrics['decode_ms_per_step']:.2f} ms/step over "
        f"{engine.n_decode_steps} steps, "
        f"{metrics['decode_tokens_per_s']:.1f} decode tokens/s")
    log(f"  weight bytes {weight_bytes}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()}")
    return dict(metrics, launches=launches)


# --------------------------------------------------------------------- #
# phase 2: the stream_ops chain in the SASS; the card's INT32 add rate
# --------------------------------------------------------------------- #

def find_cuobjdump(nvcc: str) -> str:
    """cuobjdump beside nvcc, else on PATH."""
    import shutil
    here = Path(nvcc).parent / "cuobjdump"
    found = str(here) if here.is_file() else shutil.which("cuobjdump")
    if not found:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    return found


def stream_sass_counts(_build) -> dict:
    """Per element of the k = 128 instances of csrc/microbench.cu (4
    elements per thread and step): the predicated integer adds of the int32
    chain, by opcode, all integer adds, and the f32 adds."""
    funcs = sass_functions(_build.build_dir() / "libmicrobench.so",
                           _build.find_nvcc())

    def only(tag):
        hits = [n for n in funcs if tag in n]
        if len(hits) != 1:
            raise AssertionError(f"SASS: want one function matching {tag}, "
                                 f"got {hits}")
        return funcs[hits[0]]

    # integer adds: IADD3 (INT32 pipe), and VIADD / IMAD.IADD, which
    # ptxas may issue to balance the adds over two pipes
    int_adds = ("IADD3", "IADD", "VIADD", "IMAD.IADD", "IADD32I")
    i32 = only("stream_i32ILi128E")
    predicated, chain = {}, {}
    for ins in i32:
        if ins.startswith("@P"):
            op = opcode(ins)
            predicated[op] = predicated.get(op, 0) + 1
            if op in int_adds:
                chain[op] = chain.get(op, 0) + 1
    return {
        "chain_adds_per_elem": sum(chain.values()) / 4,
        "chain_opcodes": chain, "predicated_opcodes": predicated,
        "f32_adds_per_elem": sum(opcode(i).startswith("FADD")
                                 for i in only("stream_f32ILi128E")) / 4,
    }


def sass_functions(lib: Path, nvcc: str) -> dict:
    """Mangled function name -> its SASS instructions, from cuobjdump."""
    sass = subprocess.run([find_cuobjdump(nvcc), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs = {}
    for chunk in sass.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        funcs[name.strip()] = re.findall(
            r"^\s*/\*[0-9a-f]{4,}\*/\s*([^;]+?)\s*;", body, re.M)
    return funcs


def opcode(ins: str) -> str:
    """The opcode of one SASS instruction, past its predicate."""
    words = ins.split()
    return words[1] if words[0].startswith("@") else words[0]


def kernel_label(mangled: str) -> str:
    """`flash_mma_kernel<128>` for a mangled kernel name of csrc/."""
    m = re.search(r"([A-Za-z][A-Za-z_]*?_kernel)I(.+?)EEv", mangled)
    if not m:
        plain = re.search(r"\d([A-Za-z][A-Za-z_]*?_kernel)E?P", mangled)
        return plain.group(1) if plain else mangled
    args, rest = [], m.group(2)
    while rest:
        n = re.match(r"Li(\d+)E", rest)
        if rest.startswith("13__nv_bfloat16"):
            args.append("bf16")
            rest = rest[len("13__nv_bfloat16"):]
        elif rest[0] in "fij":
            args.append({"f": "f32", "i": "int32", "j": "uint32"}[rest[0]])
            rest = rest[1:]
        elif n:
            args.append(n.group(1))
            rest = rest[n.end():]
        elif (sub := re.match(r"S\d*_", rest)):     # a repeated __nv_bfloat16
            args.append("bf16")
            rest = rest[sub.end():]
        elif re.match(r"Lb[01]E", rest):
            args.append("true" if rest[2] == "1" else "false")
            rest = rest[4:]
        elif (named := re.match(r"NS_(\d+)", rest)):   # a struct of csrc's
            end = named.end() + int(named.group(1))
            args.append(rest[named.end():end])
            rest = rest[end:].removeprefix("E")
        else:
            args.append(rest)
            break
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_per_kernel(log_text: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill-store bytes, static shared-memory bytes)
    from one source's ptxas -v."""
    out = []
    for chunk in log_text.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        out.append((kernel_label(name), int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else -1,
                    int(smem.group(1)) if smem else 0))
    return out


def bulk_copy_counts(_build) -> dict:
    """Bulk-copy instructions (cp.async.bulk: UBLKCP and the other BLK
    opcodes) in the SASS of every ring kernel of va and gemv, by opcode;
    raises where a ring kernel has none."""
    counts = {}
    for stem in ("va", "gemv"):
        funcs = sass_functions(_build.build_dir() / f"lib{stem}.so",
                               _build.find_nvcc())
        for name, body in funcs.items():
            if "ring_kernel" in name:
                ops_ = [opcode(i) for i in body if "BLK" in opcode(i)]
                counts[kernel_label(name)] = {
                    op: ops_.count(op) for op in sorted(set(ops_))}
    if not counts or not all(counts.values()):
        raise AssertionError(f"ring kernels without bulk copies in their "
                             f"SASS: {counts}")
    return counts


def hmma_counts(_build) -> dict:
    """HMMA instructions in the SASS of each tensor-core flash kernel."""
    funcs = sass_functions(_build.build_dir() / "libflash_attention.so",
                           _build.find_nvcc())
    counts = {kernel_label(n): sum(opcode(i).startswith("HMMA") for i in body)
              for n, body in funcs.items() if "flash_mma_kernel" in n}
    if not counts or not all(counts.values()):
        raise AssertionError(f"tensor-core flash kernels without HMMA "
                             f"instructions in their SASS: {counts}")
    return counts


def int32_add_rate(sass) -> tuple[float, str]:
    """Adds per second: SMs x lanes x the SM's maximum clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    two_pipes = set(sass["chain_opcodes"]) - {"IADD3"}
    lanes = ISSUE_LANES_PER_SM if two_pipes else INT32_LANES_PER_SM
    why = (f"{sms} SMs x {lanes} lanes x {mhz:.0f} MHz (clocks.max.sm); "
           + (f"the chain also uses {sorted(two_pipes)}, which can issue "
              "beside the INT32 pipe, so the SM's issue limit"
              if two_pipes else "all chain adds are IADD3 on the INT32 pipe"))
    return sms * lanes * mhz * 1e6, why


# --------------------------------------------------------------------- #
# phase 6: the streaming kernels at the paper's sizes
# --------------------------------------------------------------------- #

def within_bf16_rounding(got, want, slack: float = 0.0) -> bool:
    """|got - want| at most one bf16 spacing at the larger magnitude, plus
    `slack`."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return bool(((g - w).abs() <= spacing + slack).all())


def gemv_check(what, A, x, got, want) -> float:
    """Hold a gemv result to the f64 product (A f32: within GEMV_F32_TOL of
    the output's scale) or to its plain version `want` (A bf16: within one
    bf16 rounding of it, beyond the f32 band by which the two f32 sums,
    taken in other orders, may differ before they are rounded: a row whose
    exact value is near 0 after cancellation can round its two sums to bf16
    values many of their spacings apart); returns max |got - f64|."""
    y64 = A.double() @ x.double()
    err = float((got.double() - y64).abs().max()) if got.numel() else 0.0
    scale = float(y64.abs().max()) if got.numel() else 0.0
    if got.dtype != A.dtype:
        raise AssertionError(f"gemv {what}: {got.dtype}, want {A.dtype}")
    if A.dtype == torch.float32:
        if err > GEMV_F32_TOL * max(scale, 1e-30):
            raise AssertionError(f"gemv {what}: {err:.3g} from f64")
    elif not within_bf16_rounding(got, want, GEMV_F32_TOL * scale):
        raise AssertionError(f"gemv {what}: more than one bf16 rounding "
                             f"from the plain version")
    return err


def edge_checks(ops, ref, gen):
    """Small cases that reach each kernel's other branches: ragged tails,
    unaligned views (va's and gemv's second routes, the scalar paths), n and
    M below one ring stage, K beyond one stage, other dtypes and k. Every
    route of va and gemv must launch."""
    from repro_torch.kernels import gemv as kgemv
    from repro_torch.kernels import va as kva
    dev = "cuda"
    routes = {"va": (kva.KERNEL, tuple(kva.ROUTE_CODE)),
              "gemv": (kgemv.KERNEL, tuple(kgemv.ROUTE_CODE))}

    def launched():
        return {(name, r): kern.route_count(r)
                for name, (kern, names) in routes.items() for r in names}
    before = launched()
    n = (1 << 20) + 3
    for dt in (torch.int32, torch.float32, torch.bfloat16):
        if dt == torch.int32:
            a, b = (torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                                  device=dev, dtype=dt) for _ in range(2))
        else:
            a, b = (torch.randn(n, generator=gen, device=dev).to(dt)
                    for _ in range(2))
        stage = kva.STAGE_BYTES // a.element_size()
        # ragged tail, unaligned, below one stage, one stage, whole stages
        for x, y in ((a, b), (a[1:], b[1:]), (a[:100], b[:100]),
                     (a[:stage], b[:stage]), (a[:-3], b[:-3])):
            want = ref.va(x, y)
            for route in ("stride",) if x.data_ptr() % 16 else kva.ROUTE_CODE:
                if not torch.equal(kva.va(x, y, route), want):
                    raise AssertionError(f"va {dt} n={x.numel()} route "
                                         f"{route}: not exact")
            if not torch.equal(ops.va(x, y), want):
                raise AssertionError(f"va {dt} n={x.numel()}: not exact")
        for x in (a, a[1:], a[:1]):
            got, want = float(ops.reduction(x)), float(x.double().sum())
            tol = 1e-5 * float(x.double().abs().sum()) + 1e-6
            if abs(got - want) > tol:
                raise AssertionError(f"reduction {dt} n={x.numel()}: {got} "
                                     f"vs f64 {want}")
    f32, bf16 = torch.float32, torch.bfloat16
    # (M, K, A dtype, x dtype, offset of A in its buffer, route)
    for m, k, adt, xdt, off, route in (
            (300, 700, bf16, bf16, 0, "rows"),       # K * size % 16 != 0
            (8, 8, f32, f32, 0, "ring"),
            (3, 4096, bf16, bf16, 0, "ring"),        # M below one stage
            (1000, 4096, bf16, f32, 0, "ring"),
            (77, 9000, f32, bf16, 0, "ring"),        # K beyond one stage
            (1001, 12800, bf16, bf16, 0, "ring"),
            (129, 2048, f32, f32, 1, "rows"),        # unaligned A
            (64, kgemv.MAX_RING_K + 4, f32, f32, 0, "rows"),   # x too long
            (1, 0, f32, f32, 0, "rows")):
        buf = (torch.randn(m * k + off, generator=gen, device=dev) / 8)
        A = buf.to(adt)[off:].view(m, k)
        x = (torch.randn(k, generator=gen, device=dev) / 8).to(xdt)
        if kgemv.plan_for(A).route != route:
            raise AssertionError(f"gemv {m}x{k} offset {off}: route "
                                 f"{kgemv.plan_for(A).route}, want {route}")
        got = ops.gemv(A, x)
        gemv_check(f"{m}x{k} {adt}/{xdt} {route}", A, x, got, ref.gemv(A, x))
        if not torch.equal(got, ops.gemv(A, x)):
            raise AssertionError(f"gemv {m}x{k}: two launches differ")
    after = launched()
    unused = [f"{name} {r}" for (name, r), n in after.items()
              if n == before[(name, r)]]
    if unused:
        raise AssertionError(f"edge cases never launched {unused}")
    xi = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                       device=dev, dtype=torch.int32)
    xf = torch.randn(n, generator=gen, device=dev) * 100
    for x in (xi, xf, xi[1:], xf[1:]):
        for k in (0, 3, 128, 200):
            if not torch.equal(ops.stream_ops(x, k),
                               ref.microbench_stream(x, k)):
                raise AssertionError(f"stream_ops {x.dtype} k={k} "
                                     f"n={x.numel()}: not exact")
    log("  edge cases: va, reduction, gemv and stream_ops agree on ragged, "
        "unaligned, below-one-stage, long-K, other-dtype and other-k "
        "inputs; routes launched: "
        + str({f"{name} {r}": n - before[(name, r)]
               for (name, r), n in after.items()}))


def streaming_kernels(ops, ref, kernels, int_rate):
    """Phase 6. Returns ({kernel: row}, launches of the ops path run)."""
    from repro_torch.kernels import gemv as kgemv
    from repro_torch.kernels import va as kva
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    edge_checks(ops, ref, gen)
    n = PRIM_N
    va_sets = [tuple(torch.randint(0, 1 << 30, (n,), generator=gen,
                                   device=dev, dtype=torch.int32)
                     for _ in range(2)) for _ in range(2)]
    red_sets = [(torch.rand(n, generator=gen, device=dev),) for _ in range(2)]
    gemv_sets = [[((torch.randn(m, k, generator=gen, device=dev) / 8).to(dt),
                   (torch.randn(k, generator=gen, device=dev) / 8).to(dt))
                  for _ in range(2 if m * k > 1e8 else 3)]
                 for m, k, dt, _ in GEMV_CASES]
    torch.cuda.synchronize()

    # the path: each kernel through its `ops` entry point, counted
    for kern in kernels.values():
        kern.reset()
    va_out = ops.va(*va_sets[0])
    red_out = ops.reduction(*red_sets[0])
    gemv_out = [ops.gemv(*sets[0]) for sets in gemv_sets]
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    want = {"va": 1, "reduction": 1, "gemv": len(GEMV_CASES)}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"phase 6 launches {launches}, want {want}")
    routes = {"va": dict(kva.KERNEL.route_launches),
              "gemv": dict(kgemv.KERNEL.route_launches)}
    log(f"  routes of the path's launches: {routes}")
    if kva.KERNEL.route_count("ring") != 1 or \
            kgemv.KERNEL.route_count("ring") != len(GEMV_CASES):
        raise AssertionError(f"phase 6 routes {routes}: want va and every "
                             f"gemv on the ring")
    va_plan = kva.plan_for(*va_sets[0], va_out)
    log(f"  va route {va_plan.route}, grid {va_plan.blocks} x "
        f"{va_plan.threads}, {va_plan.smem} bytes of shared memory, "
        f"{va_plan.units} stages cut {va_plan.per_block} (+1 for "
        f"{va_plan.extra} blocks), tail {va_plan.tail}")
    for (m, k, dt, what), sets in zip(GEMV_CASES, gemv_sets):
        p = kgemv.plan_for(sets[0][0])
        log(f"  gemv {what} route {p.route}, grid {p.blocks} x {p.threads}, "
            f"{p.smem} bytes of shared memory, {m} rows cut {p.per_block} "
            f"(+1 for {p.extra} blocks), stages of {p.kc} columns "
            f"({p.stage_bytes} bytes)")

    rows = {}
    a, b = va_sets[0]
    want = ref.va(a, b)
    va_err = max_abs_err(va_out, want)
    if not torch.equal(va_out, want):
        raise AssertionError("va at 2^27 int32: not bit-exact")
    if not torch.equal(va_out, ops.va(a, b)):
        raise AssertionError("va at 2^27 int32: two launches differ")
    if not torch.equal(kva.va(a, b, "stride"), want):
        raise AssertionError("va at 2^27 int32, route stride: not exact")
    del want
    rb, rf = bound(3 * 4 * n, n, int_rate)
    rows["va"] = {"case": "n=2^27 int32", "max_abs_err": va_err,
                  "bound_ms": rb, "bound_by": rf, "route": va_plan.route,
                  "grid": va_plan.blocks, "bit_identical_twice": True,
                  **card_times(ops.va, ref.va, torch.add, va_sets)}
    # the stride route, the kernel before the ring, on the same arrays
    rows["va"]["stride_ms"] = graph_ms(
        functools.partial(kva.va, route="stride"), va_sets)

    x = red_sets[0][0]
    exact = float(x.double().sum())
    got = float(red_out)
    if red_out.view(torch.int32).item() != \
            ops.reduction(x).view(torch.int32).item():
        raise AssertionError("reduction: two launches gave different bits")
    if abs(got - exact) > 1e-5 * abs(exact):
        raise AssertionError(f"reduction at 2^27 f32: {got} vs f64 {exact}")
    rb, rf = bound(4 * n + 4, n, PEAK_FLOPS[torch.float32])
    rows["reduction"] = {
        "case": "n=2^27 f32 uniform [0,1)",
        "max_abs_err": abs(got - float(ref.reduction(x))),
        "rel_err_vs_f64": abs(got - exact) / abs(exact),
        "bound_ms": rb, "bound_by": rf,
        **card_times(ops.reduction, ref.reduction,
                     lambda t: torch.sum(t, dtype=torch.float32), red_sets)}

    gemv_rows = []
    for (m, k, dt, what), sets, got in zip(GEMV_CASES, gemv_sets, gemv_out):
        A, xv = sets[0]
        want_ = ref.gemv(A, xv)
        err = gemv_check(what, A, xv, got, want_)
        if not torch.equal(got, ops.gemv(A, xv)):
            raise AssertionError(f"gemv {what}: two launches differ")
        gemv_check(f"{what}, route rows", A, xv,
                   kgemv.gemv(A, xv, "rows"), want_)
        isz = torch.finfo(dt).bits // 8
        rb, rf = bound(isz * (m * k + k + m), 2.0 * m * k, PEAK_FLOPS[dt])
        p = kgemv.plan_for(A)
        gemv_rows.append({
            "case": f"{what} {m}x{k} {str(dt).split('.')[-1]}",
            "max_abs_err": float((got.float() - want_.float()).abs().max()),
            "max_abs_err_vs_f64": err, "bound_ms": rb, "bound_by": rf,
            "route": p.route, "grid": p.blocks, "bit_identical_twice": True,
            **card_times(ops.gemv, ref.gemv, torch.mv, sets, 5, 4),
            # the rows route on the same matrices: the first kernel
            "rows_ms": graph_ms(functools.partial(kgemv.gemv, route="rows"),
                                sets)})
    rows["gemv"] = gemv_rows[0]
    del va_sets, red_sets, gemv_sets, va_out, gemv_out
    torch.cuda.empty_cache()

    # the H100's Fig. 2 curve
    sets = [(torch.randint(0, 127, (n,), generator=gen, device=dev,
                           dtype=torch.int32),) for _ in range(2)]
    curve = []
    for k in FIG2_K:
        got = ops.stream_ops(sets[0][0], k)
        want = ref.microbench_stream(sets[0][0], k)
        err = max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"stream_ops k={k} at 2^27: not bit-exact")
        del got, want
        kernel = functools.partial(ops.stream_ops, ops_per_elem=k)
        ms = graph_ms(kernel, sets)
        rb, rf = bound(8 * n, k * n, int_rate)
        curve.append({
            "k": k, "oi_op_per_byte": k / 4.0, "ms": ms,
            "launched_ms": median_ms(kernel, sets), "max_abs_err": err,
            "bound_ms": rb,
            "bound_by": rf, "gops": k * n / ms / 1e6,
            "gb_per_s": 8 * n / ms / 1e6, "share_of_bound": rb / ms,
            "plain_ms": median_ms(lambda t: ref.microbench_stream(t, k),
                                  sets, reps=3, per_rep=2)})
    pt = next(c for c in curve if c["k"] == STREAM_ROW_K)
    # no library call does this work: x + k(k+1)/2 gives the same values
    # with one add, and the k adds are the measurement
    rows["stream_ops"] = {"case": f"n=2^27 int32 k={STREAM_ROW_K}",
                          "max_abs_err": pt["max_abs_err"],
                          "bound_ms": pt["bound_ms"],
                          "bound_by": pt["bound_by"], "ms": pt["ms"],
                          "launched_ms": pt["launched_ms"],
                          "plain_ms": pt["plain_ms"], "library_ms": None}
    del sets
    torch.cuda.empty_cache()

    for name, r in rows.items():
        log(f"  {name} {r['case']}: " + ", ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items() if k != "case"))
    for r in gemv_rows[1:]:
        log(f"  gemv {r['case']}: " + ", ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items() if k != "case"))
    log("  Fig. 2 on this card: stream_ops, n=2^27 int32 (8 bytes moved "
        "per element; op/B as in fig2_rows, adds per 4-byte element read)")
    for c in curve:
        log(f"    k={c['k']:3d} op/B={c['oi_op_per_byte']:6.2f} "
            f"ms={c['ms']:.6g} launched_ms={c['launched_ms']:.6g} "
            f"bound_ms={c['bound_ms']:.6g} "
            f"({c['bound_by']}) Gop/s={c['gops']:.6g} "
            f"GB/s={c['gb_per_s']:.6g} of_bound={c['share_of_bound']:.3f} "
            f"plain_ms={c['plain_ms']:.6g}")
    # past the knee the time must grow with k: each compute-bound point
    # at least 1.3x the one before it (2x when wholly compute-bound)
    ms_by_k = [c["ms"] for c in curve]
    past = [c["ms"] for c in curve if c["bound_by"] == "operations"]
    if len(past) < 2 or not all(b > 1.3 * a for a, b in zip(past, past[1:])) \
            or not ms_by_k[-1] > 2 * ms_by_k[0]:
        raise AssertionError(f"Fig. 2: time does not rise with k past the "
                             f"knee: {ms_by_k}")
    return rows, launches


# --------------------------------------------------------------------- #
# phase 7: the Fig. 2 entry point
# --------------------------------------------------------------------- #

def microbench_entry_point(kernels):
    """`python -m repro_torch.benchmarks.run microbench`, in process."""
    from repro_torch.benchmarks import microbench, run

    for kern in kernels.values():
        kern.reset()
    if run.main(["microbench"]) != 0:
        raise AssertionError("repro_torch.benchmarks.run microbench failed")
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    want = {name: 0 for name in kernels}
    want["stream_ops"] = len(microbench.SWEEP_K)
    log(f"  launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError("the entry point did not run through the "
                             "stream_ops kernel alone")
    return launches


# --------------------------------------------------------------------- #
# phase 8: the PrIM bank-local kernels at PrIM's sizes
# --------------------------------------------------------------------- #

def int32_randint(gen, lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def prim_edge_checks(ops, ref, gen):
    """Small cases: ragged and unaligned lengths, n < 128, f32 scan data,
    out-of-range histogram values, a planted ts tie, m = n, m = 512,
    8191 x 8193."""
    from repro_torch.kernels import scan_block, ts
    dev = "cuda"
    ints = functools.partial(int32_randint, gen)
    for n in (1, 100, 8191, 8192, 8193, 50_000, (1 << 20) + 3):
        x = ints(-100, 100, n + 1)
        for v in (x[:n], x[1:]):          # 16-byte aligned, and not
            got = ops.scan(v)
            exact = torch.cumsum(v.long(), 0).to(torch.int32)
            if not (torch.equal(got, ref.scan(v)) and torch.equal(got, exact)):
                raise AssertionError(f"scan int32 n={n}: not exact")
            (sk, tk), (sp, tp) = scan_block.scan_blocks(v), ref.scan_blocks(v)
            if not (torch.equal(sk, sp) and torch.equal(tk, tp)):
                raise AssertionError(f"scan_blocks int32 n={n}: not exact")
    n = (1 << 20) + 3
    xf = torch.randn(n + 1, generator=gen, device=dev)
    for what, v in (("aligned", xf[:n]), ("unaligned", xf[1:])):
        got, plain = ops.scan(v), ref.scan(v)
        exact = torch.cumsum(v.double(), 0)
        scale = float(exact.abs().max())
        err = float((got.double() - exact).abs().max())
        err_plain = float((plain.double() - exact).abs().max())
        log(f"  scan f32 n=2^20+3 {what}: max err vs f64 {err:.6g} (plain "
            f"{err_plain:.6g}, max |prefix| {scale:.6g}), bit-equal to the "
            f"plain version: {torch.equal(got, plain)}")
        if err > SCAN_F32_TOL * scale or err > err_plain:
            raise AssertionError(f"scan f32 n={n} {what}: too far from f64")
    s = torch.randn(n + 1, generator=gen, device=dev) * 1000
    off = torch.randn(-(-n // ref.SCAN_TILE), generator=gen, device=dev) * 1e4
    for v in (s[:n], s[1:]):
        for dt in (torch.float32, torch.int32):
            if not torch.equal(scan_block.add_offsets(v, off, dt),
                               ref.add_offsets(v, off, dt)):
                raise AssertionError(f"add_offsets {dt}: not exact")

    oob = torch.tensor([1, 4095, 4096, 70000, 2 ** 32 - 1]).to(torch.int32)
    oob = oob.to(dev).view(torch.uint32)
    got = ops.histogram(oob, 256)
    if not (torch.equal(got, ref.histogram(oob, 256)) and int(got.sum()) == 2
            and int(got[0]) == 1 and int(got[255]) == 1):
        raise AssertionError(f"histogram out of range: {got.nonzero()}")
    wide = ints(-2 ** 31, 2 ** 31 - 1, 100_003)   # every bit pattern
    for bins in (256, 4096):
        if not torch.equal(ops.histogram(wide, bins), ref.histogram(wide, bins)):
            raise AssertionError(f"histogram wrapping products, bins={bins}")
    for n in (1, 100, 4097, (1 << 20) + 3):
        x = ints(0, 1 << 12, n + 1)
        for v in (x[:n], x[1:], x[:n].view(torch.uint32)):
            for bins in (1, 3, 256, 1000, 4096, 8192):
                got = ops.histogram(v, bins)
                if not torch.equal(got, ref.histogram(v, bins)) \
                        or int(got.sum()) != n:
                    raise AssertionError(f"histogram n={n} bins={bins}")

    for n, m, dt in ((100, 8, torch.int32), (5000, 8, torch.float32),
                     (4103, 512, torch.int32), (4103, 512, torch.float32),
                     (300, 300, torch.int32), (512, 512, torch.float32),
                     (1, 1, torch.float32), (2049, 16, torch.int32)):
        if dt == torch.int32:
            series, query = ints(-100, 100, n), ints(-100, 100, m)
        else:
            series = torch.randn(n, generator=gen, device=dev) * 10
            query = torch.randn(m, generator=gen, device=dev) * 10
        dk, dp = ts.ts_dists(series, query), ref.ts_dists(series, query)
        d, i = ops.ts_min(series, query)
        if not torch.equal(dk, dp) or int(i) != int(torch.argmin(dp)) \
                or not torch.equal(d, dp.min()):
            raise AssertionError(f"ts n={n} m={m} {dt}: not exact")
    before = ts.KERNEL.launches
    for n, m, dt in ((16, 32, torch.int32), (1, 2, torch.float32),
                     (100, 512, torch.int32)):
        d, i = ops.ts_min(ints(-100, 100, n).to(dt), ints(-100, 100, m).to(dt))
        if not (d.is_cuda and i.is_cuda and d.dim() == 0 and i.dim() == 0
                and d.dtype == torch.float32 and i.dtype == torch.int32
                and float(d) == float("inf") and int(i) == 0):
            raise AssertionError(f"ts n={n} < m={m} {dt}: got ({d}, {i}), "
                                 f"want (inf, 0)")
    if ts.KERNEL.launches != before:
        raise AssertionError("ts with m > n launched the kernel")
    series, query = ints(-100, 100, 1 << 20), ints(-100, 100, TS_M)
    for p in (1000, 500_000):            # the same window twice: a tie at 0
        series[p:p + TS_M] = query
    d, i = ops.ts_min(series, query)
    if float(d) != 0.0 or int(i) != 1000 or \
            int(i) != int(torch.argmin(ref.ts_dists(series, query))):
        raise AssertionError(f"ts tie: got ({float(d)}, {int(i)}), want "
                             f"(0, 1000)")

    for m, n in ((8191, 8193), (1, 1), (5, 300), (33, 31), (128, 128)):
        for dt in (torch.float32, torch.int32):
            A = ints(-1000, 1000, m, n).to(dt)
            if not torch.equal(ops.transpose(A), A.t()):
                raise AssertionError(f"transpose {m}x{n} {dt}: not exact")
    log("  edge cases: scan, histogram, ts and transpose agree on ragged, "
        "unaligned, small, out-of-range, tied, m = n and m > n inputs")


def prim_kernels(ops, ref, kernels, int_rate):
    """Phase 8. Returns ({kernel: row}, launches of the ops path run)."""
    from repro_torch.kernels import histogram, scan_block, trns, ts
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    prim_edge_checks(ops, ref, gen)
    ints = functools.partial(int32_randint, gen)

    scan_sets = [(ints(-100, 100, PRIM_SCAN_N),) for _ in range(2)]
    hst_sets = [(ints(0, 1 << 12, PRIM_HST_N).view(torch.uint32),)
                for _ in range(2)]
    ts_sets = [(ints(-100, 100, PRIM_TS_N), ints(-100, 100, TS_M))
               for _ in range(2)]
    trns_sets = [(ints(-1000, 1000, PRIM_TRNS, PRIM_TRNS),) for _ in range(2)]
    torch.cuda.synchronize()

    # the path: each entry point at its PrIM size, counted
    for kern in kernels.values():
        kern.reset()
    scan_out = ops.scan(*scan_sets[0])
    scan32_out = ops.scan(*scan_sets[0], acc=torch.int32)
    hst_out = [ops.histogram(*hst_sets[0], b) for b in HST_BINS]
    ts_out = ops.ts_min(*ts_sets[0])
    trns_out = ops.transpose(*trns_sets[0])
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    want = {name: 0 for name in kernels}
    want.update(scan_blocks=1, add_offsets=1, scan_lookback=1,
                histogram=len(HST_BINS),
                ts_dists=1, transpose=1)
    log(f"  launches {launches}")
    if launches != want:
        raise AssertionError(f"phase 8 launches {launches}, want {want}")

    # each kernel and the whole path against the plain versions on the
    # path's own tensors; errs: kernel -> max |kernel - plain|
    errs = {}
    x = scan_sets[0][0]
    if not torch.equal(scan_out, ref.scan(x)):
        raise AssertionError("scan at 2^27 int32: not bit-exact")
    if not torch.equal(scan32_out, ref.scan(x, torch.int32)):
        raise AssertionError("scan at 2^27 int32, int32 route: not bit-exact")
    (sk, tk), (sp, tp) = scan_block.scan_blocks(x), ref.scan_blocks(x)
    errs["scan_blocks"] = max(max_abs_err(sk, sp), max_abs_err(tk, tp))
    off = ref.tile_offsets(tk)
    ak = scan_block.add_offsets(sk, off, torch.int32)
    ap = ref.add_offsets(sk, off, torch.int32)
    errs["add_offsets"] = max_abs_err(ak, ap)
    if not (torch.equal(sk, sp) and torch.equal(tk, tp)
            and torch.equal(ak, ap)):
        raise AssertionError(f"scan pair at 2^27 int32: not bit-exact "
                             f"(scan_blocks {errs['scan_blocks']}, "
                             f"add_offsets {errs['add_offsets']})")
    del sk, tk, sp, tp, off, ak, ap
    h = hst_sets[0][0]
    hst_errs = []
    for b, got in zip(HST_BINS, hst_out):
        want = ref.histogram(h, b)
        hst_errs.append(max_abs_err(got, want))
        if not torch.equal(got, want) or int(got.sum()) != PRIM_HST_N:
            raise AssertionError(f"histogram at 2^26, {b} bins: not exact")
    series, query = ts_sets[0]
    dk, dp = ts.ts_dists(series, query), ref.ts_dists(series, query)
    ip = torch.argmin(dp)
    errs["ts_dists"] = max_abs_err(dk, dp)
    if not torch.equal(dk, dp) or int(ts_out[1]) != int(ip) \
            or not torch.equal(ts_out[0], dp[ip]):
        raise AssertionError("ts at 2^26, m=8: not bit-exact")
    want = trns_sets[0][0].t()
    errs["transpose"] = max_abs_err(trns_out, want)
    if not torch.equal(trns_out, want):
        raise AssertionError("transpose 8192x8192: not exact")
    del scan_out, scan32_out, hst_out, trns_out, dk, dp, want
    torch.cuda.empty_cache()

    f32 = PEAK_FLOPS[torch.float32]
    n, tiles = PRIM_SCAN_N, PRIM_SCAN_N // ref.SCAN_TILE
    rows = {}
    rb, rf = bound(8 * n + 4 * tiles, n, f32)
    cumsum = functools.partial(torch.cumsum, dim=0, dtype=torch.float32)
    rows["scan_blocks"] = {
        "case": "n=2^27 int32 [-100,100)",
        "max_abs_err": errs["scan_blocks"],
        "bound_ms": rb, "bound_by": rf,
        **card_times(scan_block.scan_blocks, ref.scan_blocks, cumsum,
                     scan_sets, 3, 2),
        "library_call": "torch.cumsum(x, 0, dtype=torch.float32): the whole "
                        "scan, both phases"}
    add_sets = [(s, ref.tile_offsets(t)) for s, t in
                (scan_block.scan_blocks(*xs) for xs in scan_sets)]
    rb, rf = bound(8 * n + 4 * tiles, n, f32)
    rows["add_offsets"] = {
        "case": "n=2^27 f32 scans + offsets -> int32",
        "max_abs_err": errs["add_offsets"],
        "bound_ms": rb, "bound_by": rf,
        **card_times(lambda s, o: scan_block.add_offsets(s, o, torch.int32),
                     lambda s, o: ref.add_offsets(s, o, torch.int32),
                     lambda s, o: s.view(-1, ref.SCAN_TILE) + o[:, None],
                     add_sets, 3, 2),
        "library_call": "scans.view(-1, 8192) + offsets[:, None]"}
    del add_sets
    whole = card_times(ops.scan, ref.scan, None, scan_sets, 3, 2)
    whole["library_ms"] = rows["scan_blocks"]["library_ms"]
    del scan_sets
    torch.cuda.empty_cache()

    hst_rows = []
    hf_sets = [(t.view(torch.int32).float(),) for (t,) in hst_sets]
    for b, err in zip(HST_BINS, hst_errs):
        got = histogram.histogram(h, b)
        lib = torch.histc(hf_sets[0][0], bins=b, min=0, max=1 << 12)
        if not torch.equal(lib.to(torch.int32), got):
            raise AssertionError(f"torch.histc gives other bins at {b}")
        rb, rf = bound(4 * PRIM_HST_N + 4 * b, PRIM_HST_N, int_rate)
        hst_rows.append({
            "case": f"n=2^26 uint32 < 2^12, {b} bins", "max_abs_err": err,
            "bound_ms": rb, "bound_by": rf,
            **card_times(lambda t: histogram.histogram(t, b),
                         lambda t: ref.histogram(t, b), None, hst_sets, 3, 2),
            "library_ms": graph_ms(
                lambda t: torch.histc(t, bins=b, min=0, max=1 << 12), hf_sets),
            "library_launched_ms": median_ms(
                lambda t: torch.histc(t, bins=b, min=0, max=1 << 12), hf_sets),
            "library_call": "torch.histc of an f32 copy over [0, 4096)"})
    rows["histogram"] = hst_rows[0]
    del hst_sets, hf_sets

    nwin = PRIM_TS_N - TS_M + 1
    rb, rf = bound(4 * (PRIM_TS_N + TS_M + nwin), 3 * TS_M * nwin, f32)
    rows["ts_dists"] = {
        "case": f"n=2^26 int32, m={TS_M}", "max_abs_err": errs["ts_dists"],
        "bound_ms": rb, "bound_by": rf,
        **card_times(ts.ts_dists, ref.ts_dists, None, ts_sets, 3, 2),
        "library_call": "none: no single call computes the windowed "
                        "distances with the same arithmetic"}
    # launched: its d[i] reads the index on the host, which no graph holds
    ts_whole = median_ms(ops.ts_min, ts_sets)
    del ts_sets

    rb, rf = bound(8 * PRIM_TRNS * PRIM_TRNS, 0, f32)
    rows["transpose"] = {
        "case": "8192x8192 int32", "max_abs_err": errs["transpose"],
        "bound_ms": rb, "bound_by": rf,
        **card_times(trns.transpose, ref.trns, lambda A: A.t().contiguous(),
                     trns_sets),
        "library_call": "A.t().contiguous() (also the plain version)"}
    del trns_sets
    torch.cuda.empty_cache()

    for name, r in rows.items():
        log(f"  {name} {r['case']}: " + ", ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items() if k != "case"))
    r = hst_rows[1]
    log(f"  histogram {r['case']}: " + ", ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in r.items() if k != "case"))
    log(f"  ops.scan whole (both kernels + the fixed-order scan of the "
        f"{tiles} tile totals on the card), n=2^27 int32: ms={whole['ms']:.6g}, "
        f"launched_ms={whole['launched_ms']:.6g}, "
        f"plain_ms={whole['plain_ms']:.6g}, torch.cumsum "
        f"ms={whole['library_ms']:.6g}")
    log(f"  ops.ts_min whole (ts_dists + torch.argmin), n=2^26, m={TS_M}: "
        f"launched_ms={ts_whole:.6g}")
    return rows, launches

# --------------------------------------------------------------------- #
# phase 9: the PrIM workloads on the card
# --------------------------------------------------------------------- #

INT32_ROUTED = ("gemv", "reduction", "scan_blocks", "add_offsets",
                "scan_lookback")


def prim_launches(name: str, banks: int) -> dict:
    """The kernel launches of one run of workload `name` on `banks` banks:
    one launch a bank-local phase, over all banks at once for VA, GEMV,
    MLP (a layer) and TRNS, once a bank for the reductions over a shard
    (RED, SCAN, HST, TS)."""
    b = banks
    return {"VA": {"va": 1}, "GEMV": {"gemv": 1}, "MLP": {"gemv": 3},
            "RED": {"reduction": b},
            "SCAN-SSA": {"scan_lookback": b, "add_offsets": b},
            "SCAN-RSS": {"reduction": b, "scan_lookback": b},
            "HST-S": {"histogram": b}, "HST-L": {"histogram": b},
            "TS": {"ts_dists": b}, "TRNS": {"transpose": 1}}.get(name, {})


def reset_counts(kernels):
    for kern in kernels.values():
        kern.reset()


def read_counts(kernels, what: str, want: dict) -> dict:
    """Launch counts since `reset_counts`; raises unless they are `want`
    (kernel -> launches, every other kernel 0) with every launch of gemv,
    reduction, the scan pair and scan_lookback on the int32 route."""
    torch.cuda.synchronize()
    launches = {k: kern.launches for k, kern in kernels.items()}
    full = {k: want.get(k, 0) for k in kernels}
    if launches != full:
        raise AssertionError(f"{what}: launches {launches}, want {full}")
    for k in INT32_ROUTED:
        if kernels[k].route_count("int32") != launches[k]:
            raise AssertionError(f"{what}: {k} routes "
                                 f"{dict(kernels[k].route_launches)}, want "
                                 f"every launch on the int32 route")
    return launches


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time (ms) of `fn` up to a card sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def prim_workloads(kernels):
    """Phase 9, the workloads. Returns (launches of the counted runs per
    kernel, rows of the one-bank runs)."""
    from repro_torch import prim
    from repro_torch.benchmarks.prim_bench import agrees
    from repro_torch.core.bank_parallel import BankGrid
    total = dict.fromkeys(kernels, 0)
    rows = []
    for banks in (1, MULTIBANK):
        grid = BankGrid(banks, "cuda")
        for name, mod in prim.WORKLOADS.items():
            if banks == 1:
                n = NW_CARD_N if name == "NW" else mod.REF_N
            else:
                n = MULTIBANK_SIZES.get(name, MULTIBANK_N)
            gen = torch.Generator(device="cuda").manual_seed(
                SEED + 9 + zlib.crc32(name.encode()))
            inputs = prim.make_inputs(name, n, gen, "cuda")
            torch.cuda.synchronize()
            reset_counts(kernels)
            got = mod.run_pim(grid, **inputs)
            launches = read_counts(kernels, f"{name} on {banks} bank(s)",
                                   prim_launches(name, banks))
            for k, v in launches.items():
                total[k] += v
            want = mod.ref(**inputs)
            if not agrees(name, got, want, inputs):
                raise AssertionError(f"{name} n={n} on {banks} bank(s): "
                                     f"run_pim disagrees with ref")
            used = {k: v for k, v in launches.items() if v}
            if banks == 1:
                row = {"workload": name, "n": n,
                       "ms": host_ms(lambda: mod.run_pim(grid, **inputs)),
                       "ref_ms": host_ms(lambda: mod.ref(**inputs)),
                       "launches": used}
                rows.append(row)
                cut = (f" (cut from REF_N {mod.REF_N}: the plain oracle is "
                       f"a cell-by-cell loop on the host)"
                       if n != mod.REF_N else "")
                log(f"  {name} n={n}{cut}, 1 bank: equal to ref; run_pim "
                    f"{row['ms']:.6g} ms, ref {row['ref_ms']:.6g} ms "
                    f"(host clock, median of 5); launches {used}")
            else:
                log(f"  {name} n={n}, {banks} banks: equal to ref; "
                    f"launches {used}")
            del inputs, got, want
            torch.cuda.empty_cache()
    return total, rows


def scan_lookback_checks(ref, gen):
    """Phase 9: the single-pass scan bit-exact against its plain version
    and against torch.cumsum int32 (plus the carry): carries, wrapping
    sums, edge lengths, unaligned views, graph replays, and a stress loop
    of back-to-back launches on two streams."""
    from repro_torch.kernels import scan_block as kscan
    i32, dev, tile = torch.int32, "cuda", ref.SCAN_TILE
    ints = functools.partial(int32_randint, gen)
    carries = [None] + [torch.tensor([c], dtype=i32, device=dev)
                        for c in (0, 2**31 - 1, -2**31)]

    def exact(x, carry):
        want = torch.cumsum(x, 0, dtype=i32)
        return want if carry is None else want + carry

    def check(x, carry, what):
        got = kscan.scan_lookback(x, carry)
        if not (torch.equal(got, exact(x, carry))
                and torch.equal(got, ref.scan_add(x, carry))):
            c = None if carry is None else int(carry)
            raise AssertionError(f"scan_lookback {what}, carry {c}: not "
                                 f"exact")

    lengths = (1, 31, tile - 1, tile, tile + 1, (1 << 20) + 3,
               (1 << 27) + 5)
    for n in lengths:
        small = ints(-100, 100, n + 1)             # PrIM's data
        wide = ints(-2**31, 2**31 - 1, n + 1)      # sums wrap at once
        for carry in carries:
            check(small[:n], carry, f"n={n} [-100,100)")
            check(wide[:n], carry, f"n={n} wrapping")
            check(wide[1:], carry, f"n={n} wrapping, unaligned view")
        del small, wide
    torch.cuda.empty_cache()

    # a CUDA graph of one launch replays the scratch's reset with it
    x = ints(-2**31, 2**31 - 1, STRESS_N)
    want = exact(x, None)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kscan.scan_lookback(x)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = kscan.scan_lookback(x)
    torch.cuda.current_stream().wait_stream(side)
    for r in range(3):
        out.zero_()
        graph.replay()
        if not torch.equal(out, want):
            raise AssertionError(f"scan_lookback graph replay {r}: not "
                                 f"exact")
    del graph, out

    # back-to-back launches, alternating between two streams, each
    # result compared on the card; one sync at the end
    carry = carries[2]
    want_c = exact(x, carry)
    bad = [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2)]
    side.wait_stream(torch.cuda.current_stream())
    t0 = time.perf_counter()
    for i in range(STRESS_LAUNCHES):
        if i % 2:
            with torch.cuda.stream(side):
                bad[1] += (kscan.scan_lookback(x, carry) != want_c).sum()
        else:
            bad[0] += (kscan.scan_lookback(x) != want).sum()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if int(bad[0]) or int(bad[1]):
        raise AssertionError(f"scan_lookback stress: {int(bad[0])} and "
                             f"{int(bad[1])} wrong elements over "
                             f"{STRESS_LAUNCHES} launches")
    log(f"  scan_lookback bit-exact vs its plain version and torch.cumsum "
        f"int32 at n={lengths}, carries None/0/2^31-1/-2^31, wrapping "
        f"data, unaligned views, 3 graph replays, and {STRESS_LAUNCHES} "
        f"back-to-back launches over 2^22 on two streams ({secs:.3g} s)")


def int32_routes(ops, ref, int_rate):
    """Phase 9, the int32 routes at PrIM's sizes: bit-exact against their
    plain versions, timed by graph replay beside their bounds and the
    library's int32 calls. Returns {route: row}."""
    from repro_torch.kernels import gemv as kgemv
    from repro_torch.kernels import reduction as kred
    from repro_torch.kernels import scan_block as kscan
    i32 = torch.int32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    ints = functools.partial(int32_randint, gen)
    n, tiles = PRIM_N, PRIM_N // ref.SCAN_TILE
    rows = {}
    scan_lookback_checks(ref, gen)

    red_sets = [(ints(-1000, 1000, n),) for _ in range(2)]
    x = red_sets[0][0]
    got, want = kred.reduction(x, i32), ref.reduction(x, i32)
    if not torch.equal(got, want) or int(got) != int(torch.sum(x, dtype=i32)):
        raise AssertionError("int32 reduction at 2^27: not exact")
    rb, rf = bound(4 * n + 4, n, int_rate)
    rows["reduction int32"] = {
        "case": "n=2^27 int32 [-1000,1000) -> int32", "max_abs_err": 0.0,
        "bound_ms": rb, "bound_by": rf,
        **card_times(lambda t: kred.reduction(t, i32),
                     lambda t: ref.reduction(t, i32),
                     lambda t: torch.sum(t, dtype=i32), red_sets),
        "library_call": "torch.sum(x, dtype=torch.int32)"}
    del red_sets, x

    scan_sets = [(ints(-100, 100, n),) for _ in range(2)]
    x = scan_sets[0][0]
    (sk, tk), (sp, tp) = kscan.scan_blocks(x, i32), ref.scan_blocks(x, i32)
    off = ref.tile_offsets(tk)
    ak = kscan.add_offsets(sk, off, i32)
    exact = torch.cumsum(x, 0, dtype=i32)
    if not (torch.equal(sk, sp) and torch.equal(tk, tp) and torch.equal(
            ak, ref.add_offsets(sk, off, i32)) and torch.equal(ak, exact)
            and torch.equal(ops.scan(x, acc=i32), exact)):
        raise AssertionError("int32 scan at 2^27: not exact")
    del sk, tk, sp, tp, off, ak, exact
    cumsum = functools.partial(torch.cumsum, dim=0, dtype=i32)
    rb, rf = bound(8 * n + 4 * tiles, n, int_rate)
    rows["scan_blocks int32"] = {
        "case": "n=2^27 int32 [-100,100) -> int32 scans, totals",
        "max_abs_err": 0.0, "bound_ms": rb, "bound_by": rf,
        **card_times(lambda t: kscan.scan_blocks(t, i32),
                     lambda t: ref.scan_blocks(t, i32), cumsum, scan_sets,
                     3, 2),
        "library_call": "torch.cumsum(x, 0, dtype=torch.int32): the whole "
                        "scan, both phases"}
    add_sets = [(s, ref.tile_offsets(t)) for s, t in
                (kscan.scan_blocks(xs, i32) for (xs,) in scan_sets)]
    rows["add_offsets int32"] = {
        "case": "n=2^27 int32 scans + int32 offsets -> int32",
        "max_abs_err": 0.0, "bound_ms": rb, "bound_by": rf,
        **card_times(lambda s, o: kscan.add_offsets(s, o, i32),
                     lambda s, o: ref.add_offsets(s, o, i32),
                     lambda s, o: s.view(-1, ref.SCAN_TILE) + o[:, None],
                     add_sets, 3, 2),
        "library_call": "scans.view(-1, 8192) + offsets[:, None]"}
    del add_sets

    def pair_scan(t):
        scans, totals = kscan.scan_blocks(t, i32)
        return kscan.add_offsets(scans, ref.tile_offsets(totals), i32)

    rb, rf = bound(8 * n, n, int_rate)
    rows["scan pair int32, whole"] = {
        "case": "n=2^27 int32, both kernels + the tile offsets",
        "max_abs_err": 0.0, "bound_ms": rb, "bound_by": rf,
        **card_times(pair_scan, lambda t: ref.scan(t, i32), cumsum,
                     scan_sets, 3, 2),
        "library_call": "torch.cumsum(x, 0, dtype=torch.int32)"}
    rows["ops.scan int32"] = {
        "case": "n=2^27 int32 [-100,100), one scan_lookback launch",
        "max_abs_err": max_abs_err(ops.scan(x, acc=i32), ref.scan(x, i32)),
        "bound_ms": rb, "bound_by": rf,
        **card_times(lambda t: ops.scan(t, acc=i32),
                     lambda t: ref.scan(t, i32), cumsum, scan_sets, 3, 2),
        "library_call": "torch.cumsum(x, 0, dtype=torch.int32)"}
    del scan_sets
    torch.cuda.empty_cache()

    for m, k, lo, hi, what in ((8192, 2048, 0, 64, "PrIM GEMV"),
                               (4096, 4096, -4, 5, "PrIM MLP layer")):
        sets = [(ints(lo, hi, m, k), ints(lo, hi, k)) for _ in range(3)]
        A, xv = sets[0]
        got = kgemv.gemv(A, xv)
        if not torch.equal(got, ref.gemv(A, xv, i32)):
            raise AssertionError(f"int32 gemv {what}: not exact")
        rb, rf = bound(4 * (m * k + k + m), 2 * m * k, int_rate)
        rows[f"gemv int32 {what}"] = {
            "case": f"{m}x{k} int32 [{lo},{hi}), route "
                    f"{kgemv.plan_for(A).route}",
            "max_abs_err": 0.0, "bound_ms": rb, "bound_by": rf,
            **card_times(kgemv.gemv, lambda a, v: ref.gemv(a, v, i32), None,
                         sets, 3, 2),
            "library_call": "none: the card has no int32 matmul"}
        del sets, A, xv, got
    torch.cuda.empty_cache()
    for name, r in rows.items():
        log(f"  {name} {r['case']}: " + ", ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items() if k != "case"))
    return rows


# --------------------------------------------------------------------- #
# phase 10: the PrIM entry point
# --------------------------------------------------------------------- #

def prim_entry_point(kernels):
    """`python -m repro_torch.benchmarks.run prim_bench`, in process."""
    from repro_torch import prim
    from repro_torch.benchmarks import prim_bench, run
    want = {}
    for name in prim.WORKLOADS:
        for k, v in prim_launches(name, 1).items():
            want[k] = want.get(k, 0) + v
    reset_counts(kernels)
    if run.main(["prim_bench"]) != 0:
        raise AssertionError("repro_torch.benchmarks.run prim_bench failed")
    launches = read_counts(kernels, "prim_bench", want)
    log(f"  launches {launches} (Table I, one bank each)")
    fig = prim_bench.fig4()
    for name, ref_value in FIG4_ANCHORS.items():
        got = getattr(fig, name)
        log(f"  Fig. 4 anchor {name} (modelled): {got!r}, the reference's "
            f"{ref_value!r}")
        if abs(got - ref_value) > FIG4_REL * abs(ref_value):
            raise AssertionError(f"Fig. 4 anchor {name}: {got!r}, the "
                                 f"reference's model gives {ref_value!r}")
    return launches



# --------------------------------------------------------------------- #
# phase 11: MoE on the card (qwen2-moe-a2.7b)
# --------------------------------------------------------------------- #

@contextmanager
def recorded_dispatch(record):
    """Record every MoE dispatch of the model: its expert ids (`topi`) and
    dispatch buffer, in call order."""
    from repro_torch.models import layers as L
    saved = L.moe_dispatch

    def fn(x, router, cfg):
        out = saved(x, router, cfg)
        record.append((out[1], out[0]))
        return out
    L.moe_dispatch = fn
    try:
        yield
    finally:
        L.moe_dispatch = saved


def differing_choices(a, b) -> tuple[int, int]:
    """(token-slot expert choices that differ, all choices) between two
    runs' recorded dispatches, the top-k sets compared per token."""
    diff = total = 0
    for (ta, _), (tb, _) in zip(a, b, strict=True):
        sa, sb = ta.sort(-1).values, tb.sort(-1).values
        diff += int((sa != sb).sum())
        total += sa.numel()
    return diff, total


def cpu_last_logits(cfg, params, prompt, max_len):
    """The prefill of `prompt` on the CPU: the last token's logits, f64."""
    from repro_torch.models import forward, init_cache
    cache = init_cache(cfg, 1, max_len, "cpu")
    logits, _, _ = forward(params, cfg, tokens=prompt, cache=cache)
    return logits[0, -1, :cfg.vocab_size].double()


def moe_full_width_check(ops, ref):
    """Phase 11 (a) and (b). qwen2-moe-a2.7b at full width, 2 layers, f32:
    MOE_PROMPT-token prefill + 8 greedy decode steps through the kernels and
    through the plain versions (greedy tokens identical; logits no further
    from an f64 run of the plain path, teacher-forced on the kernels'
    tokens, than the plain f32 path's: P1's form; differing expert choices
    logged). The int8 prefill's first-token logits held to
    INT8_LOGIT_GATE against f32 and to INT8_CPU_SHARE against the CPU's
    int8 prefill. Then the int8 route on layer 0's real prefill and decode
    dispatch buffers of that run: quantize_q8 on the card bit-identical to
    the CPU's on the layer's experts, and every contraction of the int8
    expert FFN (up, gate, down) bit-exact to an int64 contraction of the
    same int8 operands on the CPU; shapes outside torch._int_mm's limits
    must raise."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, tree_map
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b"), n_layers=2,
                              dtype="float32")
    params = init_params(SEED, cfg, "cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    prompt = torch.randint(0, cfg.vocab_size, (1, MOE_PROMPT), generator=gen)
    prompt = prompt.to("cuda")
    rec_k, rec_p, rec_64 = [], [], []
    with torch.no_grad():
        with recorded_dispatch(rec_k):
            toks_k, lg_k = greedy_run(cfg, params, prompt, 512)
        with plain_attention(ops, ref):
            with recorded_dispatch(rec_p):
                toks_p, lg_p = greedy_run(cfg, params, prompt, 512)
            p64 = tree_map(lambda t: t.double(), params)
            with recorded_dispatch(rec_64):
                _, lg_64 = greedy_run(dataclasses.replace(cfg,
                                                          dtype="float64"),
                                      p64, prompt, 512, forced=toks_k)
            del p64
        # int8 experts (quantized in the forward) on the same weights, on
        # the card and on the CPU
        cfg8 = dataclasses.replace(cfg, quant="int8")
        _, lg_8 = greedy_run(cfg8, params, prompt, 512, steps=0)
        t0 = time.perf_counter()
        on_cpu = tree_map(lambda t: t.cpu(), params)
        c8, c32 = (cpu_last_logits(c, on_cpu, prompt.cpu(), 512)
                   for c in (cfg8, cfg))
        del on_cpu
        cpu_s = time.perf_counter() - t0
    err_k, err_p = rel(lg_k, lg_64), rel(lg_p, lg_64)
    n_calls = cfg.n_layers * 9
    if not len(rec_k) == len(rec_p) == len(rec_64) == n_calls:
        raise AssertionError(f"MoE f32: {len(rec_k)} dispatches, want "
                             f"{n_calls}")
    dk, total = differing_choices(rec_k, rec_p)
    d64, _ = differing_choices(rec_k, rec_64)
    prefill_buf = rec_k[0][1]
    decode_buf = rec_k[cfg.n_layers][1]         # decode step 1, layer 0
    drops = int((rec_k[0][1].abs().sum(-1) == 0).sum())
    del rec_k, rec_p, rec_64
    log(f"  tokens kernels {toks_k}")
    log(f"  tokens plain   {toks_p}")
    log(f"  logits max rel diff: kernels vs plain {rel(lg_k, lg_p):.3g}; "
        f"vs f64: kernels {err_k:.3g}, plain {err_p:.3g} "
        f"(limit {LOGIT_F64_FACTOR} x plain)")
    log(f"  expert choices differing from the plain path's: {dk} of {total}"
        f" (token x top-{cfg.top_k} x layer x forward); from the f64 run's:"
        f" {d64}; empty capacity slots in layer 0's prefill buffer "
        f"{tuple(prefill_buf.shape)}: {drops}")
    d8, d8_cpu = rel(lg_8[0], lg_k[0]), rel(c8, c32)
    d_dev = rel(lg_8[0].cpu(), c8)
    log(f"  int8 experts, first-token logits max rel diff: card int8 vs "
        f"card f32 {d8:.4g} (gate 0 < d < {INT8_LOGIT_GATE}); CPU int8 vs "
        f"CPU f32 {d8_cpu:.4g}; card int8 vs CPU int8 {d_dev:.4g} (limit "
        f"{INT8_CPU_SHARE} x {d8_cpu:.4g}); card f32 vs CPU f32 "
        f"{rel(lg_k[0].cpu(), c32):.4g}; argmax {int(lg_8[0].argmax())} / "
        f"{int(lg_k[0].argmax())}; CPU prefills {cpu_s:.1f}s")
    if not (torch.isfinite(lg_8).all() and 0 < d8 < INT8_LOGIT_GATE):
        raise AssertionError(f"MoE int8: first-token logits {d8:.3g} of "
                             f"their scale from f32, want (0, "
                             f"{INT8_LOGIT_GATE})")
    if not d_dev <= INT8_CPU_SHARE * d8_cpu:
        raise AssertionError(f"MoE int8: the card's logits are {d_dev:.3g} "
                             f"from the CPU's int8 run, int8 moves the CPU's "
                             f"by {d8_cpu:.3g}")
    if toks_k != toks_p:
        raise AssertionError("MoE f32: kernel and plain paths chose "
                             "different tokens")
    if not (torch.isfinite(lg_k).all() and err_k <= LOGIT_F64_FACTOR * err_p):
        raise AssertionError(f"MoE f32: kernel logits are {err_k:.3g} from "
                             f"f64, the plain path's {err_p:.3g}")

    # (b) the int8 route on layer 0's experts and real buffers
    layer0 = tree_map(lambda t: t[0], params["layers"][0]["mlp"])
    del params
    q8 = L.quantize_experts(layer0)
    for name, (q, scale) in q8.items():
        q_cpu, s_cpu = L.quantize_q8(layer0[name].cpu())
        if not (torch.equal(q.cpu(), q_cpu) and torch.equal(scale.cpu(),
                                                            s_cpu)):
            raise AssertionError(f"quantize_q8 of {name}: the card's "
                                 f"(q, scale) differ from the CPU's")
    log(f"  quantize_q8 on the card == on the CPU, bit for bit: "
        f"{sorted(q8)} {tuple(q8['wu'][0].shape)}")
    act = L._act_fn(cfg)
    for what, buf in (("prefill", prefill_buf), ("decode", decode_buf)):
        xq, sx = L._quantize_rows(buf.float())
        L.EXPERT_MM.reset()
        accs = {}
        for name, lhs in (("wu", xq), ("wg", xq), ("wd", None)):
            if lhs is None:
                up = accs["wu"].float() * sx * q8["wu"][1][None, :, 0, None]
                gate = accs["wg"].float() * sx * q8["wg"][1][None, :, 0, None]
                lhs, _ = L._quantize_rows(act(gate) * up)
            got = L.int8_expert_matmul(lhs, q8[name][0])
            want = torch.einsum("becd,edf->becf", lhs.cpu().long(),
                                q8[name][0].cpu().long())
            if not torch.equal(got.cpu().long(), want):
                raise AssertionError(f"int8 route, {what} {name}: int32 "
                                     f"accumulators differ from int64")
            accs[name] = got
        torch.cuda.synchronize()
        e = cfg.n_experts
        if dict(L.EXPERT_MM.route_launches) != {"int8": 3 * e}:
            raise AssertionError(f"int8 route: launches "
                                 f"{dict(L.EXPERT_MM.route_launches)}")
        log(f"  int8 route, layer 0 {what} buffer {tuple(buf.shape)}: up, "
            f"gate and down bit-exact to int64 ({3 * e} torch._int_mm "
            f"launches, rows padded to >= {L.INT_MM_MIN_ROWS}; max |acc| "
            f"{max(int(a.abs().max()) for a in accs.values())})")
    for bad in ((1, 2, 3, 2044), (1, 2, 3, 16)):
        x = torch.zeros(bad, dtype=torch.int8, device="cuda")
        w = torch.zeros((2, bad[3], 12), dtype=torch.int8, device="cuda")
        try:
            L.int8_expert_matmul(x, w)
        except ValueError as err:
            log(f"  outside torch._int_mm's limits it raises: {err}")
        else:
            raise AssertionError(f"int8 route ran at K={bad[3]}, N=12")


def moe_serve(kernels):
    """Phase 11 (c): qwen2-moe-a2.7b at full width and depth, bf16, on
    phase 5's workload, served once with bf16 experts and once with
    quant="int8" (the engine quantizes the experts once). Returns the
    attention launches of both serves and each serve's decode ms/step."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import forward, init_cache, tree_map
    from repro_torch.models import layers as L
    from repro_torch.serve import Request, ServeEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, engine, reqs = serve_workload("qwen2-moe-a2.7b")
    torch.cuda.synchronize()
    leaves = []
    tree_map(leaves.append, params)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"  init_params and engine {time.perf_counter() - t0:.2f}s: "
        f"{sum(t.numel() for t in leaves)} parameters, {weight_bytes} bytes,"
        f" max_memory_allocated {torch.cuda.max_memory_allocated()}")
    total = {name: 0 for name in kernels}
    runs, decode_ms = {}, {}
    for quant in ("", "int8"):
        label = quant or "bf16"
        if quant:
            del engine
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engine = ServeEngine(dataclasses.replace(cfg, quant=quant),
                                 params, batch_slots=4, max_len=2048,
                                 seed=SEED, device="cuda")
            torch.cuda.synchronize()
            q8 = []
            for lp in engine.params["layers"]:
                tree_map(q8.append, lp["mlp"]["q8"])
            log(f"  int8 engine: experts quantized once in "
                f"{time.perf_counter() - t0:.2f}s, "
                f"{sum(t.numel() * t.element_size() for t in q8)} bytes of "
                f"int8 weights and scales beside the bf16 weights")
            reqs = [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs]
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.reset()
        L.EXPERT_MM.reset()
        done, metrics = serve(engine, reqs)
        launches = {name: k.launches for name, k in kernels.items()}
        routes = {r: kfa.KERNEL.route_launches[r] for r in kfa.ROUTES}
        mm = dict(L.EXPERT_MM.route_launches)
        peak = torch.cuda.max_memory_allocated()
        n_fwd = engine.n_decode_steps + engine.n_prefills
        if len(done) != len(reqs) or any(
                len(r.out_tokens) != r.max_new_tokens
                or not all(0 <= t < cfg.vocab_size for t in r.out_tokens)
                for r in done):
            raise AssertionError(f"qwen2-moe {label}: requests unfinished "
                                 f"or vocab-padding tokens")
        want = {name: 0 for name in kernels}
        want.update(decode_attention=cfg.n_layers * engine.n_decode_steps,
                    flash_attention=cfg.n_layers * engine.n_prefills)
        want_mm = ({"int8": 3 * cfg.n_experts * cfg.n_layers * n_fwd}
                   if quant else {"float": 3 * cfg.n_layers * n_fwd})
        log(f"  {label}: launches {launches}, expected {want} "
            f"({engine.n_decode_steps} decode steps, {engine.n_prefills} "
            f"admissions); flash routes {routes}; expert contractions "
            f"{mm}, expected {want_mm}")
        if launches != want or engine.n_prefills != len(reqs):
            raise AssertionError(f"qwen2-moe {label}: launch counts do not "
                                 f"match the path")
        if routes != {"tensor_core": want["flash_attention"],
                      "cuda_core": 0}:
            raise AssertionError(f"qwen2-moe {label}: a prefill left the "
                                 f"tensor-core route")
        if mm != want_mm:
            raise AssertionError(f"qwen2-moe {label}: expert contractions "
                                 f"{mm}, want {want_mm}")
        for name in total:
            total[name] += launches[name]
        decode_ms[label] = metrics["decode_ms_per_step"]
        for r, ttft, toks in zip(done, metrics["ttft_ms"], metrics["tokens"]):
            log(f"  {label} req {r.rid}: prompt {len(r.prompt)}, TTFT "
                f"{ttft:.1f} ms, tokens {toks}...")
        log(f"  {label}: serve wall {metrics['wall_s']:.3f}s; prefill "
            f"{engine.prefill_s:.3f}s over {engine.n_prefills} admissions "
            f"({metrics['prefill_ms']:.1f} ms each); decode "
            f"{metrics['decode_ms_per_step']:.2f} ms/step over "
            f"{engine.n_decode_steps} steps, "
            f"{metrics['decode_tokens_per_s']:.1f} decode tokens/s; weight "
            f"bytes {weight_bytes}; max_memory_allocated {peak}")
        # the first request's first-token logits on this engine's weights
        with torch.no_grad():
            one = init_cache(engine.cfg, 1, 2048, "cuda")
            logits, _, _ = forward(engine.params, engine.cfg,
                                   tokens=reqs[0].prompt[None].cuda(),
                                   cache=one)
        runs[label] = ({r.rid: r.out_tokens for r in done},
                       logits[0, -1, :cfg.vocab_size].float())
    (tb, lb), (t8, l8) = runs["bf16"], runs["int8"]
    same = sum(a == b for rid in tb for a, b in zip(tb[rid], t8[rid]))
    n = sum(len(t) for t in tb.values())
    log(f"  int8 against bf16: first-token logits of req 0 max |diff| "
        f"{float((l8 - lb).abs().max()):.4g} (max |bf16 logit| "
        f"{float(lb.abs().max()):.4g}), argmax {int(l8.argmax())} / "
        f"{int(lb.argmax())}; identical greedy tokens {same} of {n} "
        f"({same / n:.1%})")
    del engine, params
    return total, decode_ms


# --------------------------------------------------------------------- #
# phase 12: sliding window on the card
# --------------------------------------------------------------------- #

def wrapping_schedule(engine, prompts):
    """tests/test_serve.py's windowed schedule: 16 continuous-batching
    steps with budgets of 8 tokens; {rid: tokens}."""
    from repro_torch.serve import Request
    reqs = [Request(i, p, 8) for i, p in enumerate(prompts)]
    pending = list(reqs)
    for _ in range(16):
        while pending and engine.admit(pending[0]):
            pending.pop(0)
        engine.step()
    return {r.rid: list(r.out_tokens) for r in reqs}


def window_checks(ops, ref, kernels):
    """Phase 12. REDUCED starcoder2-7b and mixtral-8x7b, f32, max_len 32 (a
    ring of 16): the 16-step wrapping schedule through the kernels and
    through the plain versions gives the same tokens. Then starcoder2-7b
    at full width, bf16: one SWA_PROMPT-token prompt (past its 4096
    window) and 16 greedy decode steps at max_len SWA_MAX_LEN (a 4096
    ring), every attention call held to the plain version in bf16 and f64
    in P5's scale-relative form. Returns the kernel runs' launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import cache_width, init_params
    from repro_torch.serve import ServeEngine

    total = {name: 0 for name in kernels}
    for arch in ("starcoder2-7b", "mixtral-8x7b"):
        cfg = dataclasses.replace(get_arch(arch, reduced=True),
                                  dtype="float32")
        assert cache_width(cfg, 32) == 16
        params = init_params(SEED, cfg, "cuda")
        gen = torch.Generator().manual_seed(SEED + 5)
        prompts = [torch.randint(0, cfg.vocab_size, (12 + i % 3,),
                                 generator=gen) for i in range(4)]
        out = {}
        for path in ("kernels", "plain"):
            eng = ServeEngine(cfg, params, batch_slots=2, max_len=32,
                              seed=SEED, device="cuda")
            for k in kernels.values():
                k.reset()
            if path == "kernels":
                out[path] = wrapping_schedule(eng, prompts)
                launches = {name: k.launches for name, k in kernels.items()}
                want = {name: 0 for name in kernels}
                want.update(
                    decode_attention=cfg.n_layers * eng.n_decode_steps,
                    flash_attention=cfg.n_layers * eng.n_prefills)
                if launches != want:
                    raise AssertionError(f"{cfg.name}: launches {launches}, "
                                         f"want {want}")
                for name in total:
                    total[name] += launches[name]
            else:
                with plain_attention(ops, ref):
                    out[path] = wrapping_schedule(eng, prompts)
        wrapped = sum(len(p) + len(t) > 16
                      for p, t in zip(prompts, out["kernels"].values()))
        log(f"  {cfg.name}: {out['kernels']} ({wrapped} of 4 requests past "
            f"the ring of 16)")
        if out["kernels"] != out["plain"] or not wrapped:
            raise AssertionError(f"{cfg.name}: kernel path {out['kernels']},"
                                 f" plain path {out['plain']}")

    cfg = get_arch("starcoder2-7b")
    assert cache_width(cfg, SWA_MAX_LEN) == cfg.sliding_window < SWA_PROMPT
    params = init_params(SEED, cfg, "cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    prompt = torch.randint(0, cfg.vocab_size, (1, SWA_PROMPT), generator=gen)
    prompt = prompt.to("cuda")
    worst = {}
    for k in kernels.values():
        k.reset()
    with torch.no_grad(), checked_attention(ops, ref, worst):
        toks, lg = greedy_run(cfg, params, prompt, SWA_MAX_LEN, steps=16)
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {r: kfa.KERNEL.route_launches[r] for r in kfa.ROUTES}
    del params
    for name in total:
        total[name] += launches[name]
    log_worst(worst, f" (kernel-f64 limit: TOL or plain-f64 + {CALL_TOL})")
    log(f"  starcoder2-7b full width, bf16, prompt {SWA_PROMPT}, ring "
        f"{cfg.sliding_window}: tokens {toks}; launches {launches}, flash "
        f"routes {routes}")
    want = {name: 0 for name in kernels}
    want.update(decode_attention=16 * cfg.n_layers,
                flash_attention=cfg.n_layers)
    if launches != want or routes != {"tensor_core": cfg.n_layers,
                                      "cuda_core": 0}:
        raise AssertionError(f"starcoder2-7b: launches {launches}, routes "
                             f"{routes}, want {want} on tensor cores")
    if sorted(worst) != ["decode_attention", "flash_attention"]:
        raise AssertionError(f"starcoder2-7b: attention calls seen {worst}")
    for name, w in worst.items():
        limit = max(TOL[(name, torch.bfloat16)], w["plain-f64"] + CALL_TOL)
        if not w["kernel-f64"] <= limit:
            raise AssertionError(f"starcoder2-7b: {name} kernel is "
                                 f"{w['kernel-f64']:.3g} of the output's "
                                 f"scale from f64, the plain version "
                                 f"{w['plain-f64']:.3g} (limit {limit:.3g})")
    if not torch.isfinite(lg).all():
        raise AssertionError("starcoder2-7b: logits not finite")
    return total


# --------------------------------------------------------------------- #
# phase 13: the program census
# --------------------------------------------------------------------- #

def printed_verdicts(text: str) -> dict:
    """The verdicts suitability_bench printed: PrIM workload -> (KT1, KT2,
    KT3, PIM-suitable), LM step -> memory-bound."""
    out = {}
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if cells[0] not in SUITABILITY_VERDICTS:
            continue
        if len(cells) == 6:
            out[cells[0]] = tuple(c == "True" for c in cells[2:])
        elif len(cells) == 4:
            out[cells[0]] = cells[2] == "True"
    return out


def suitability_entry_point(kernels):
    """Phase 13 (a): `python -m repro_torch.benchmarks.run
    suitability_bench`, in process, on the card."""
    from repro_torch.benchmarks import run
    reset_counts(kernels)
    text = io.StringIO()
    with redirect_stdout(text):
        rc = run.main(["suitability_bench"])
    sys.stdout.write(text.getvalue())
    if rc != 0:
        raise AssertionError("repro_torch.benchmarks.run suitability_bench "
                             "failed")
    read_counts(kernels, "suitability_bench", {})
    got = printed_verdicts(text.getvalue())
    log(f"  verdicts {got}")
    if got != SUITABILITY_VERDICTS:
        raise AssertionError(f"suitability verdicts {got}, the "
                             f"reference's {SUITABILITY_VERDICTS}")


def decode_step_census(arch: str, decode_ms: float) -> dict:
    """Phase 13 (b): the census of `arch`'s decode step as phase 5's
    engine runs it, on fake parameters and cache, beside the measured
    `decode_ms` per step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_arch
    from repro_torch.core.census import analyze_program
    from repro_torch.core.suitability import score
    from repro_torch.models import forward, init_cache, init_params
    from repro_torch.serve.engine import sample

    cfg = get_arch(arch)
    t0 = time.perf_counter()
    with FakeTensorMode():
        params = init_params(SEED, cfg, "cpu")
        cache = init_cache(cfg, CENSUS_SLOTS, CENSUS_MAX_LEN, "cpu")

    def step(p, c, tokens, positions):
        logits = forward(p, cfg, tokens=tokens, cache=c,
                         positions=positions)[0]
        return sample(logits[:, -1])
    an = analyze_program(step, params, cache,
                         torch.ones((CENSUS_SLOTS, 1), dtype=torch.int32),
                         torch.arange(CENSUS_SLOTS, dtype=torch.int32)[:, None]
                         * 500 + 64)
    secs = time.perf_counter() - t0
    oi = an.flops / an.hbm_bytes
    reps = {m: score(an, name=f"{arch} decode", machine=m)
            for m in ("tpu_v5e", "upmem_2556")}
    log(f"  {arch} decode step ({cfg.n_layers} layers, {cfg.dtype}, "
        f"{CENSUS_SLOTS} slots x {CENSUS_MAX_LEN}): census on fake tensors "
        f"({an.tracing}) in {secs:.2f}s: flops {an.flops:.0f} (dot "
        f"{an.dot_flops:.0f}), bytes {an.hbm_bytes:.0f}, OI {oi:.4f}")
    for m, r in reps.items():
        log(f"    on the modelled {m}: balance {r.machine_balance:.4g}, "
            f"memory-bound {r.memory_bound}, complex-op fraction "
            f"{r.complex_frac:.3f}, PIM-suitable {r.pim_suitable}")
    if not reps["tpu_v5e"].memory_bound:
        raise AssertionError(f"{arch} decode is not memory-bound")
    roof_ms = an.hbm_bytes / HBM_BYTES_PER_S * 1e3
    share = roof_ms / decode_ms
    log(f"  {arch} decode: census bytes at {HBM_BYTES_PER_S:.3g} B/s take "
        f"{roof_ms:.4f} ms; measured {decode_ms:.4f} ms/step; memory-roof "
        f"share {share:.4f}")
    if share > ROOF_SHARE_MAX:
        raise AssertionError(f"{arch} decode: census bytes need {roof_ms} ms"
                             f" at the card's rate, more than the measured "
                             f"{decode_ms} ms/step")
    return {"bytes": an.hbm_bytes, "flops": an.flops, "share": share}


# --------------------------------------------------------------------- #
# phase 14: the planner-routed path on the card
# --------------------------------------------------------------------- #

def dispatch_counts(kernels, what: str, want: dict, total: dict) -> dict:
    """Launches since `reset_counts`, which must be `want` (every other
    kernel 0), every flash launch on the route of `want["flash_route"]`
    when given; added into `total`."""
    from repro_torch.kernels import flash_attention as kfa
    want = dict(want)
    route = want.pop("flash_route", None)
    launches = read_counts(kernels, what, want)
    routes = {r: kfa.KERNEL.route_launches[r] for r in kfa.ROUTES}
    if route is not None and routes[route] != launches["flash_attention"]:
        raise AssertionError(f"{what}: flash routes {routes}, want every "
                             f"launch on {route}")
    for k, n in launches.items():
        total[k] += n
    return launches


def mixed_runtime(kernels, total, m: int = DISPATCH_MIXED_M,
                  device: str = "cuda"):
    """Phase 14 (a): `runtime.execute` of `mixed_pipeline(m)` (int32) under
    the planner's hybrid plan and all-PIM at 1 and MULTIBANK banks, bit-
    exact to `runtime.reference`; the only kernel is the transpose, one
    launch per PIM `trns` stage. Then the decode chain's exact int32
    contraction on the card and `decode_pipeline(REDUCED_DIMS)` all-PIM."""
    from repro_torch.core.bank_parallel import BankGrid
    from repro_torch.dispatch import runtime, workloads
    from repro_torch.dispatch.placement import plan, pure_plan

    pipe = workloads.mixed_pipeline(m=m, seed=SEED, device=device)
    g = pipe.graph()
    plans = {"hybrid": plan(g), "all-PIM": pure_plan(g, "upmem_2556")}
    log(f"  mixed_pipeline(m={m}) hybrid plan {plans['hybrid'].assignment}")
    for name, p in plans.items():
        n_trns = sum(p.assignment[s].startswith("upmem")
                     for s in ("trns.fwd", "trns.back"))
        for banks in (1, MULTIBANK):
            reset_counts(kernels)
            t0 = time.perf_counter()
            rep = runtime.execute(pipe, p, BankGrid(banks, device))
            secs = time.perf_counter() - t0
            launches = dispatch_counts(
                kernels, f"mixed_pipeline {name} {banks} banks",
                {"transpose": n_trns}, total)
            log(f"  mixed_pipeline {name}, {banks} banks: result "
                f"{int(rep.result)}, max |err| {rep.max_abs_err} against "
                f"runtime.reference, transpose launches "
                f"{launches['transpose']}, {secs:.3f}s with validation")
            if not rep.matches or rep.max_abs_err != 0.0:
                raise AssertionError(f"mixed_pipeline {name}: not bit-exact")
    # the decode chain's int32 attention on the card: 16-bit halves in f64
    # (`workloads._int_einsum`), bit for bit the CPU's int32 einsum on
    # full-range int32 operands (products and sums wrap)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    a, b = (torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                          device=device, dtype=torch.int32)
            for shape in ((4, 32, 128), (2048, 32, 128)))
    got = workloads._int_einsum("bhd,shd->bhs", a, b).cpu()
    if not torch.equal(got, torch.einsum("bhd,shd->bhs", a.cpu(), b.cpu())):
        raise AssertionError("_int_einsum on the card is not the CPU's int32")
    pipe = workloads.decode_pipeline(workloads.REDUCED_DIMS, seed=SEED,
                                     device=device)
    reset_counts(kernels)
    rep = runtime.execute(pipe, pure_plan(pipe.graph(), "upmem_2556"),
                          BankGrid(2, device))
    dispatch_counts(kernels, "decode_pipeline all-PIM", {}, total)
    log(f"  _int_einsum (4x32x128 by 2048x32x128, full-range int32) "
        f"bit-exact to the CPU's; decode_pipeline(REDUCED_DIMS) all-PIM on 2 "
        f"banks within rtol 1e-4 of runtime.reference (max |err| "
        f"{rep.max_abs_err:.3g}), no kernel launched")


def all_pim(cfg, prefill_chunks: int = 0) -> dict:
    """Every decode stage (or, with `prefill_chunks`, every prefill stage
    of that many chunks) of a dense model on the PIM device."""
    if prefill_chunks:
        names = ["head"] + [f"{k}/c{c}" for c in range(prefill_chunks)
                            for k in ["embed"] + [
                                f"{s}{i}" for i in range(cfg.n_layers)
                                for s in ("qkv", "attn", "o", "mlp")]]
    else:
        names = ["embed", "head"] + [f"{s}{i}" for i in range(cfg.n_layers)
                                     for s in ("qkv", "attn", "o", "mlp")]
    return {n: "upmem_2556" for n in names}


def recorded_serve(engine, reqs):
    """`serve(engine, reqs)`, with every admission's first-token logits
    and every decode step's logits kept: the dispatch steps', or the
    fused forward's. The recorders are taken off again after the run
    (they refer to the engine: left on, they would keep it alive)."""
    from repro_torch.serve import engine as engine_mod
    logits, first = [], []
    real_prefill = engine._prefill_one
    engine._prefill_one = lambda *a: first.append(
        real_prefill(*a).clone()) or first[-1]
    step = engine._dispatch_decode
    if step is not None:
        real = step.logits
        step.logits = lambda *a: logits.append(real(*a)) or logits[-1]
    else:
        real = engine_mod.forward

        def recording(*a, **kw):
            out = real(*a, **kw)
            if kw["tokens"].shape[1] == 1:
                logits.append(out[0].clone())
            return out
        engine_mod.forward = recording
    try:
        done, metrics = serve(engine, reqs)
    finally:
        del engine._prefill_one
        if step is None:
            engine_mod.forward = real
        else:
            del step.logits
    return done, metrics, logits, first


def dispatch_f32_check(ops, ref, kernels, total, device: str = "cuda"):
    """Phase 14 (b): granite-3-8b at full width, 4 layers, f32: four
    requests served by the fused engine, by `engine="dispatch"` with the
    planner's plans (each prompt one prefill chunk) and by all-PIM decode
    at 4 banks (prefill fused): greedy tokens identical and every decode
    step's logits bit for bit the fused engine's. Then prefill in
    DISPATCH_F32_CHUNK-token chunks (the flash kernel with q_offset, CUDA
    cores) in P1's form: every attention call within CALL_TOL of f64 or
    no further from it than the plain f32 version, and each prompt's
    first-token logits within DISPATCH_F32_PREFILL_REL of their scale of
    the fused whole-prompt prefill's (the one-chunk dispatch prefill's
    are its bits). Its tokens are logged beside the fused ones: chunked
    and whole-prompt prefill round apart, and later steps amplify it."""
    from repro_torch.configs import get_arch
    from repro_torch.core.bank_parallel import BankGrid
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(get_arch("granite-3-8b"), n_layers=4,
                              dtype="float32")
    params = init_params(SEED, cfg, device)
    gen = torch.Generator().manual_seed(SEED + 7)
    lens = (300, 257, 180, 64)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
               for n in lens]
    runs = {"fused": None,
            "dispatch": {"prefill_chunk": 512},
            "all-PIM x4": {"grid": BankGrid(4, device),
                           "prefill_engine": "jit",
                           "force_assignment": all_pim(cfg)},
            "chunked": {"prefill_chunk": DISPATCH_F32_CHUNK}}
    out, worst = {}, {}
    for name, dk in runs.items():
        eng = ServeEngine(cfg, params, batch_slots=4, max_len=512,
                          seed=SEED, device=device,
                          engine="jit" if dk is None else "dispatch",
                          dispatch_kwargs=dk)
        reqs = [Request(i, p, 8) for i, p in enumerate(prompts)]
        reset_counts(kernels)
        if name == "chunked":
            with checked_attention(ops, ref, worst):
                done, metrics, logits, first = recorded_serve(eng, reqs)
        else:
            done, metrics, logits, first = recorded_serve(eng, reqs)
        chunks = sum(len(eng.prefill_splits(n)) for n in lens)
        launches = dispatch_counts(kernels, f"f32 {name}", {
            "decode_attention": cfg.n_layers * eng.n_decode_steps,
            "flash_attention": cfg.n_layers * chunks,
            "flash_route": "cuda_core"}, total if dk is not None else
            {k: 0 for k in kernels})
        out[name] = ([r.out_tokens for r in done], logits, first)
        log(f"  f32 4 layers, {name}: tokens {out[name][0]}; launches "
            f"{launches}; decode {metrics['decode_ms_per_step']:.2f} ms/step")
    toks, logits, first = out["fused"]
    for name in ("dispatch", "all-PIM x4"):
        got_toks, got, _ = out[name]
        if got_toks != toks:
            raise AssertionError(f"f32 {name}: tokens {got_toks}, fused "
                                 f"{toks}")
        if len(got) != len(logits) or not all(
                torch.equal(a, b) for a, b in zip(got, logits)):
            raise AssertionError(f"f32 {name}: decode logits are not the "
                                 f"fused engine's bits")
    log(f"  f32: {len(logits)} decode steps' logits bit-identical to the "
        f"fused engine's, planned and all-PIM at 4 banks")
    log_worst(worst, f" (kernel-f64 limit: {CALL_TOL} or plain-f64)")
    if not all(torch.equal(a, b) for a, b in zip(out["dispatch"][2], first)):
        raise AssertionError("f32 dispatch: one-chunk prefill logits are "
                             "not the fused engine's bits")
    same = sum(a == b for x, y in zip(out["chunked"][0], toks)
               for a, b in zip(x, y))
    v = cfg.vocab_size                  # past it, the padding's -1e30
    rel = [float((a[:v] - b[:v]).abs().max() / b[:v].abs().max())
           for a, b in zip(out["chunked"][2], first)]
    log(f"  f32 chunked prefill: first-token logits max |chunked - fused| "
        f"/ max |fused| {rel} (limit {DISPATCH_F32_PREFILL_REL}); tokens "
        f"equal to the fused engine's {same} of {sum(map(len, toks))}; "
        f"one-chunk dispatch prefill logits bit-identical to fused")
    if len(rel) != len(lens) or max(rel) > DISPATCH_F32_PREFILL_REL:
        raise AssertionError(f"f32 chunked prefill: first-token logits "
                             f"{rel} of scale from the fused prefill's")
    if sorted(worst) != ["decode_attention", "flash_attention"]:
        raise AssertionError(f"f32 chunked: attention calls seen {worst}")
    for name, w in worst.items():
        if not w["kernel-f64"] <= max(CALL_TOL, w["plain-f64"]):
            raise AssertionError(f"f32 chunked: {name} kernel is "
                                 f"{w['kernel-f64']:.3g} of the output's "
                                 f"scale from f64, the plain version "
                                 f"{w['plain-f64']:.3g} (limit {CALL_TOL})")


def dispatch_serve(ops, ref, kernels, total, fused: dict,
                   device: str = "cuda"):
    """Phase 14 (c): granite-3-8b at full width and depth (bf16) serving
    phase 5's workload through `ServeEngine(engine="dispatch")`, once with
    the planner's plans and once with every stage on the PIM device at 4
    banks: exactly 40 decode launches a step and 40 flash launches a
    prefill chunk (tensor-core route), no other kernel; both serves the
    same tokens (their faces run the same calls). Then phase 4's bf16 form
    on the dispatch path: a BF16_PROMPT-token prompt and 8 decode steps,
    every attention call held to the plain version in bf16 and f64.
    Returns the serving metrics of both serves."""
    from repro_torch.configs import get_arch
    from repro_torch.core.bank_parallel import BankGrid
    from repro_torch.kernels import flash_attention as kfa

    cfg = get_arch("granite-3-8b")
    runs = {"planned": {},
            "all-PIM x4": {"grid": BankGrid(4, device)}}
    results = {}
    for name, dk in runs.items():
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if name == "all-PIM x4":
            dk["force_assignment"] = all_pim(cfg)
            # every chunk the prefill step plans (its default horizon,
            # PREFILL_PLANNED); later chunks route as the last planned
            dk["prefill_force_assignment"] = all_pim(cfg, PREFILL_PLANNED)
        cfg, params, engine, reqs = serve_workload(
            engine="dispatch", dispatch_kwargs=dk)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        reset_counts(kernels)
        done, metrics = serve(engine, reqs)
        chunks = sum(len(engine.prefill_splits(len(r.prompt))) for r in done)
        launches = dispatch_counts(kernels, f"dispatch serve {name}", {
            "decode_attention": SERVE_LAYERS * engine.n_decode_steps,
            "flash_attention": SERVE_LAYERS * chunks,
            "flash_route": "tensor_core"}, total)
        dec, pre = (engine._dispatch_decode.faces.stats,
                    engine._dispatch_prefill.faces.stats)
        same = sum(a == b for r, f in zip(done, fused["tokens_all"])
                   for a, b in zip(r.out_tokens, f))
        results[name] = dict(metrics, tokens_all=[r.out_tokens
                                                  for r in done])
        log(f"  dispatch {name}: engine built (weights, cache, both plans) "
            f"in {build_s:.2f}s; planning {engine._dispatch_decode.plan_s:.2f}"
            f"s decode ({engine.dispatch_plan.method}), "
            f"{engine._dispatch_prefill.plan_s:.2f}s prefill "
            f"({engine.prefill_plan.method}, "
            f"{engine._dispatch_prefill.n_chunks_planned} chunks planned)")
        log(f"  dispatch {name}: launches {launches} ({engine.n_decode_steps}"
            f" decode steps, {chunks} prefill chunks over "
            f"{engine.n_prefills} admissions), flash routes "
            f"{dict(kfa.KERNEL.route_launches)}")
        log(f"  dispatch {name}: decode {metrics['decode_ms_per_step']:.2f} "
            f"ms/step (fused phase 5: {fused['decode_ms_per_step']:.2f}), "
            f"prefill {metrics['prefill_ms']:.1f} ms/admission (fused "
            f"{fused['prefill_ms']:.1f}), TTFT ms "
            f"{[round(t, 1) for t in metrics['ttft_ms']]} (fused "
            f"{[round(t, 1) for t in fused['ttft_ms']]}), serve wall "
            f"{metrics['wall_s']:.3f}s (fused {fused['wall_s']:.3f}s)")
        log(f"  dispatch {name}: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()}; tokens equal to the "
            f"fused serve's {same} of {sum(map(len, fused['tokens_all']))}")
        log(f"  dispatch {name}: FaceCache decode {dec}")
        log(f"  dispatch {name}: FaceCache prefill {pre}")
        if name == "all-PIM x4":
            if results[name]["tokens_all"] != \
                    results["planned"]["tokens_all"]:
                raise AssertionError("dispatch all-PIM x4 and planned "
                                     "serves chose different tokens")
            if dec["pim"]["calls"] == 0 or dec["host"]["calls"] != 0:
                raise AssertionError(f"all-PIM decode faces {dec}")
        for r in done:
            if len(r.out_tokens) != r.max_new_tokens or not all(
                    0 <= t < cfg.vocab_size for t in r.out_tokens):
                raise AssertionError(f"dispatch {name} req {r.rid}: tokens "
                                     f"{r.out_tokens}")
        if name == "planned":
            dispatch_bf16_form(ops, ref, kernels, total, engine, cfg)
        # nothing refers back to the engine: dropping it frees its
        # weights and cache at once, with no cycle collection
        del engine, params
        left = torch.cuda.memory_allocated() - base
        log(f"  dispatch {name}: {left} bytes still allocated after the "
            f"engine is dropped")
        if left > LEFT_AFTER_DROP:
            raise AssertionError(f"dispatch {name}: {left} bytes outlive "
                                 f"the dropped engine")
        torch.cuda.empty_cache()
    return results


def dispatch_bf16_form(ops, ref, kernels, total, engine, cfg):
    """Phase 4's bf16 form on the dispatch path: every attention call of a
    BF16_PROMPT-token admission (prefill chunks through the flash kernel
    with q_offset) and 8 decode steps held to its plain version in bf16
    and f64 on the model's own activations."""
    from repro_torch.serve import Request
    gen = torch.Generator().manual_seed(SEED + 3)
    prompt = torch.randint(0, cfg.vocab_size, (BF16_PROMPT,), generator=gen)
    worst = {}
    reset_counts(kernels)
    with torch.no_grad(), checked_attention(ops, ref, worst):
        req = Request(100, prompt, 9)
        engine.admit(req)
        for _ in range(8):
            engine.step()
    chunks = len(engine.prefill_splits(BF16_PROMPT))
    dispatch_counts(kernels, "dispatch bf16 form", {
        "decode_attention": 8 * SERVE_LAYERS,
        "flash_attention": chunks * SERVE_LAYERS,
        "flash_route": "tensor_core"}, total)
    log_worst(worst, f" (kernel-f64 limit: TOL or plain-f64 + {CALL_TOL})")
    log(f"  dispatch bf16 form: {BF16_PROMPT}-token prompt in {chunks} "
        f"chunks, tokens {req.out_tokens}")
    if sorted(worst) != ["decode_attention", "flash_attention"]:
        raise AssertionError(f"dispatch bf16: attention calls seen {worst}")
    for name, w in worst.items():
        limit = max(TOL[(name, torch.bfloat16)], w["plain-f64"] + CALL_TOL)
        if not w["kernel-f64"] <= limit:
            raise AssertionError(f"dispatch bf16: {name} kernel is "
                                 f"{w['kernel-f64']:.3g} of the output's "
                                 f"scale from f64, the plain version "
                                 f"{w['plain-f64']:.3g} (limit {limit:.3g})")


def dispatch_reduced(kernels, total, device: str = "cuda"):
    """Phase 14 (d): REDUCED mixtral-8x7b (int8 experts, the expert-
    parallel DAG with expert_shards=2 on two ranks, single-chunk prefill)
    and starcoder2-7b (banded prefill: 22-token prompts in 4-token chunks),
    f32, through `engine="dispatch"`: tokens identical to the fused
    engine's on the card; first the int8 expert contraction at mixtral's
    REDUCED widths bit-exact to int64."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    from repro_torch.serve import Request, ServeEngine

    mix = dataclasses.replace(get_arch("mixtral-8x7b", reduced=True),
                              dtype="float32", quant="int8")
    # the int8 expert contraction at these widths (K = 64 is padded to
    # INT_MM_MIN_K) against an int64 contraction on the CPU
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    fe = mix.moe_d_ff or mix.d_ff
    for k, n in ((mix.d_model, fe), (fe, mix.d_model)):
        xq = torch.randint(-127, 128, (2, mix.n_experts, 3, k), generator=gen,
                           device=device, dtype=torch.int32).to(torch.int8)
        wq = torch.randint(-127, 128, (mix.n_experts, k, n), generator=gen,
                           device=device, dtype=torch.int32).to(torch.int8)
        got = L.int8_expert_matmul(xq, wq).cpu().long()
        want = torch.einsum("becd,edf->becf", xq.cpu().long(),
                            wq.cpu().long())
        if not torch.equal(got, want):
            raise AssertionError(f"int8_expert_matmul K={k} N={n}: not the "
                                 f"int64 contraction")
    log(f"  int8_expert_matmul at {mix.name}'s widths (K {mix.d_model}, "
        f"{fe}): bit-exact to int64")
    star = dataclasses.replace(get_arch("starcoder2-7b", reduced=True),
                               dtype="float32")
    forced = {}
    for i in range(mix.n_layers):
        forced[f"expert{i}@r0"] = "upmem_2556"
        forced[f"expert{i}@r1"] = "upmem_2556:1"
    cases = [
        (mix, [12, 13, 14, 12], 8, 16, {
            "expert_shards": 2, "force_assignment": forced,
            "devices": ("xeon", "upmem_2556", "upmem_2556:1"),
            "prefill_chunk": 32}),
        (star, [22, 20, 9, 18], 3, 12, {"prefill_chunk": 4}),
    ]
    for cfg, lens, budget, steps, dk in cases:
        params = init_params(SEED, cfg, device)
        gen = torch.Generator().manual_seed(SEED + 8)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
                   for n in lens]
        out = {}
        for name in ("fused", "dispatch"):
            eng = ServeEngine(cfg, params, batch_slots=2, max_len=32,
                              seed=SEED, device=device,
                              engine="jit" if name == "fused" else
                              "dispatch",
                              dispatch_kwargs=None if name == "fused"
                              else dict(dk))
            reqs = [Request(i, p, budget) for i, p in enumerate(prompts)]
            pending = list(reqs)
            reset_counts(kernels)
            for _ in range(steps):
                while pending and eng.admit(pending[0]):
                    pending.pop(0)
                eng.step()
            torch.cuda.synchronize()
            launches = {k: kern.launches for k, kern in kernels.items()}
            if name == "dispatch":
                for k in total:
                    total[k] += launches[k]
            out[name] = [r.out_tokens for r in reqs]
        log(f"  {cfg.name} REDUCED ({cfg.quant or cfg.dtype}): dispatch "
            f"tokens {out['dispatch']}; launches {launches}")
        if out["dispatch"] != out["fused"]:
            raise AssertionError(f"{cfg.name}: dispatch tokens "
                                 f"{out['dispatch']}, fused {out['fused']}")
        extra = {k for k, n in launches.items() if n} - {
            "decode_attention", "flash_attention"}
        if extra or not launches["decode_attention"] \
                or not launches["flash_attention"]:
            raise AssertionError(f"{cfg.name}: dispatch launches {launches}")


# --------------------------------------------------------------------- #
# phase 15: the serving gateway on the card
# --------------------------------------------------------------------- #

def gateway_full_width(kernels, served, total, smi: str,
                       device: str = "cuda", **workload):
    """Phase 15 (a): gateway_bench's full-width workload
    (`full_width_gateway`: granite-3-8b at full width and depth behind
    `Gateway` under seeded Poisson arrivals, the plan cache prewarmed;
    `workload` shrinks it for a CPU rehearsal), its gates
    (`check_full_width`: every request done, no plan solved in band), and
    exactly one decode-attention kernel a layer and decode step and one
    flash kernel (tensor-core route) a layer and admission. Prints the
    gateway's `GatewayStats.rows()` and one `{"gateway": {...}}` JSON
    line. Returns the JSON's dict."""
    from repro_torch.benchmarks import gateway_bench as gb

    fw = gb.full_width_gateway(device, **workload)
    engine, cfg = fw.engine, fw.cfg
    log(f"  prewarm: {fw.prewarm['misses']} plan solves in "
        f"{fw.prewarm_s:.2f}s, cache {fw.prewarm}")
    steps0, prefills0 = engine.n_decode_steps, engine.n_prefills
    reset_counts(kernels)
    stats = fw.gateway.run(fw.requests)
    if device == "cuda":
        torch.cuda.synchronize()
    steps = engine.n_decode_steps - steps0
    admissions = engine.n_prefills - prefills0
    want = {"decode_attention": cfg.n_layers * steps,
            "flash_attention": cfg.n_layers * admissions}
    if device == "cuda":
        want["flash_route"] = "tensor_core"
    launches = dispatch_counts(kernels, "gateway full width", want, total)
    for row in stats.rows():
        log(f"  {row[0]:22s} {row[1]}")
    log(f"  arrivals at {fw.rate_rps:.4f} req/s ({gb.FULL_LOAD} x "
        f"{fw.sustain_rps:.4f}: {fw.admission_s * 1e3:.1f} ms an admission, "
        f"{fw.step_s * 1e3:.2f} ms/step on the warmed engine; phase 5: "
        f"{served['prefill_ms']:.1f} ms, {served['decode_ms_per_step']:.2f}"
        f" ms/step); launches {launches} over {steps} decode steps and "
        f"{admissions} admissions")
    gb.check_full_width(fw, stats)
    if admissions != len(fw.requests):
        raise AssertionError(f"gateway: {admissions} admissions of "
                             f"{len(fw.requests)} requests")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "slots": engine.n_slots, "max_len": engine.max_len,
           "requests": len(fw.requests), "new_tokens": gb.FULL_NEW,
           "prompt_lens": sorted({len(g.prompt) for g in fw.requests}),
           "admission_ms": fw.admission_s * 1e3,
           "step_ms": fw.step_s * 1e3, "rate_rps": fw.rate_rps,
           "completed": stats.completed, "duration_s": stats.duration_s,
           "sustained_rps": stats.sustained_rps,
           "goodput_rps": stats.goodput_rps,
           "slo_ttft_s": gb.FULL_SLO_TTFT_S, "slo_itl_s": gb.FULL_SLO_ITL_S,
           "ttft_p50_ms": stats.ttft_p50_s * 1e3,
           "ttft_p99_ms": stats.ttft_p99_s * 1e3,
           "itl_p50_ms": stats.itl_p50_s * 1e3,
           "itl_p99_ms": stats.itl_p99_s * 1e3,
           "tokens_per_s": stats.tokens / stats.duration_s,
           "decode_steps": steps, "prewarm_s": fw.prewarm_s,
           "prewarm_solves": fw.prewarm["misses"],
           "hit_rate": stats.plan_cache["hit_rate"],
           "pos_bucket": fw.gateway.pos_bucket, "card": smi}
    print(json.dumps({"gateway": out}), flush=True)
    return out


def gateway_pair(kernels, total, device: str = "cuda",
                 arch: str = "granite-3-8b", reduced: bool = False,
                 max_len: int = 1024):
    """Phase 15 (b): the same GATEWAY_PAIR_REQUESTS requests (prompts within
    one 512-token prefill chunk, three priority classes, dense arrivals)
    through a gateway over the fused engine and one over
    `engine="dispatch"`, on one set of weights (phase 14 (b)'s model:
    full width, GATEWAY_PAIR_LAYERS layers, f32), each under its own
    `ManualClock(tick=1e-3)`: identical decisions (admission order,
    `admit_s`, token times, reject reasons, stats, plan-cache keys) and
    identical tokens. A tracer on the dispatch run feeds the planner-
    fidelity gate on its decode DAG and plan."""
    from repro_torch.configs import get_arch
    from repro_torch.dispatch import trace as dtrace
    from repro_torch.models import init_params
    from repro_torch.serve import (Gateway, ManualClock, ServeEngine,
                                   poisson_requests)

    cfg = dataclasses.replace(get_arch(arch, reduced=reduced),
                              n_layers=GATEWAY_PAIR_LAYERS, dtype="float32")
    params = init_params(SEED, cfg, device)
    top = min(512, max_len - 16)
    runs = {}
    for name in ("fused", "dispatch"):
        kw = ({"engine": "dispatch", "dispatch_kwargs": {
            "prefill_chunk": 512}} if name == "dispatch" else {})
        engine = ServeEngine(cfg, params, batch_slots=4, max_len=max_len,
                             seed=SEED, device=device, **kw)
        gw = Gateway(engine, queue_capacity=8, pos_bucket=64,
                     clock=ManualClock(tick=1e-3))
        if name == "dispatch":
            tracer = dtrace.Trace("gateway-dispatch")
            gw.attach_tracer(tracer)
        reqs = poisson_requests(GATEWAY_PAIR_REQUESTS, 100.0, seed=SEED + 11,
                                vocab=cfg.vocab_size, prompt_lens=(16, top),
                                max_new=(4, 12))
        if not all(engine.prefill_splits(len(g.prompt)) == [len(g.prompt)]
                   for g in reqs):
            raise AssertionError(f"{name}: a prompt takes more than one "
                                 f"prefill chunk")
        steps0, prefills0 = engine.n_decode_steps, engine.n_prefills
        reset_counts(kernels)
        stats = gw.run(reqs)
        want = {"decode_attention":
                cfg.n_layers * (engine.n_decode_steps - steps0),
                "flash_attention":
                cfg.n_layers * (engine.n_prefills - prefills0)}
        launches = dispatch_counts(kernels, f"gateway pair {name}", want,
                                   total)
        everyone = sorted(gw.finished + gw.rejected, key=lambda g: g.rid)
        runs[name] = {
            "decisions": [(g.rid, g.state, g.reject_reason, g.admit_s,
                           g.finish_s, tuple(g.token_times))
                          for g in everyone],
            "admit_order": [g.rid for g in sorted(
                gw.finished, key=lambda g: g.admit_s)],
            "stats": dataclasses.astuple(stats),
            "keys": list(gw.plans._entries),
            "tokens": [g.out_tokens for g in everyone]}
        log(f"  {name}: {stats.completed} done of {stats.offered}, "
            f"{stats.steps} steps, admit order {runs[name]['admit_order']}, "
            f"plan cache {stats.plan_cache}, launches {launches}")
        if name == "dispatch":
            step = engine._dispatch_decode
            rep = dtrace.fidelity(step.dag, step.plan, trace=tracer)
            log(f"  dispatch: {rep.render()}; prefill executor cache "
                f"{engine._dispatch_prefill.executor_cache.stats}; decode "
                f"spans {len(tracer.by_kind('decode_step'))}, prefill spans "
                f"{len(tracer.by_kind('prefill_step'))}")
            if not rep.ok:
                raise AssertionError(f"gateway dispatch: {rep.render()}")
        del engine, gw
    f, d = runs["fused"], runs["dispatch"]
    log(f"  tokens {f['tokens']}")
    for key in ("decisions", "admit_order", "stats", "keys"):
        if f[key] != d[key]:
            raise AssertionError(f"gateway pair: {key} differ: fused "
                                 f"{f[key]}, dispatch {d[key]}")
    if f["tokens"] != d["tokens"]:
        raise AssertionError(f"gateway pair: tokens differ: fused "
                             f"{f['tokens']}, dispatch {d['tokens']}")


def gateway_entry_points(kernels, total, device: str = "cuda"):
    """Phase 15 (c): `python -m repro_torch.benchmarks.run gateway_bench
    --quick --trace <tmp>`, `dispatch_bench --quick` and `scaling_bench`,
    each in process on `device`: each must exit 0 (its gates held). The
    gateway bench serves REDUCED granite-3-8b (bf16) through both engines:
    attention kernels only; the other two plan and model: no launch."""
    import tempfile

    from repro_torch.benchmarks import run
    extra = [] if device == "cuda" else ["--device", device]
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "gateway_trace.json"
        for argv in (["gateway_bench", "--quick", "--trace", str(trace)],
                     ["dispatch_bench", "--quick"], ["scaling_bench"]):
            reset_counts(kernels)
            if run.main(argv + extra) != 0:
                raise AssertionError(f"repro_torch.benchmarks.run "
                                     f"{' '.join(argv)} failed")
            if device == "cuda":
                torch.cuda.synchronize()
            launches = {k: kern.launches for k, kern in kernels.items()}
            for k, n in launches.items():
                total[k] += n
            log(f"  {' '.join(argv)}: exit 0, launches "
                f"{ {k: n for k, n in launches.items() if n} }")
            used = {k for k, n in launches.items() if n}
            if argv[0] == "gateway_bench":
                if used != {"decode_attention", "flash_attention"}:
                    raise AssertionError(f"gateway_bench launches {launches}")
                doc = json.loads(trace.read_text())
                chrome = trace.with_name("gateway_trace.chrome.json")
                log(f"  gateway trace: {len(doc['events'])} events, Chrome "
                    f"twin {chrome.stat().st_size} bytes")
            elif used:
                raise AssertionError(f"{argv[0]} launched {launches}")


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
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", out)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             out)]
        log(f"  {name}: {len(regs)} kernels, registers {min(regs, default=0)}"
            f"-{max(regs, default=0)}, spill stores up to "
            f"{max(spills, default=0)} bytes")
    for src in ("flash_attention.cu", "decode_attention.cu", "va.cu",
                "gemv.cu", "scan.cu"):
        for label, regs, spill, smem in ptxas_per_kernel(
                _build.BUILD_LOG.get(src, "")):
            log(f"    {src} {label}: {regs} registers, {spill} bytes spill "
                f"stores, {smem} bytes static shared memory")
    log(f"  bulk copies in the ring kernels' SASS: {bulk_copy_counts(_build)}"
        f" (dynamic shared memory: phase 6 logs each launch's)")
    hmma = hmma_counts(_build)
    log(f"  HMMA instructions in the tensor-core flash kernels' SASS: {hmma}")
    sass = stream_sass_counts(_build)
    log(f"  stream_ops k=128 SASS, per element: "
        f"{sass['chain_adds_per_elem']:g} predicated integer adds "
        f"{sass['chain_opcodes']} (predicated instructions "
        f"{sass['predicated_opcodes']}); f32 chain "
        f"{sass['f32_adds_per_elem']:g} FADD")
    if sass["chain_adds_per_elem"] < 128 or sass["f32_adds_per_elem"] < 128:
        raise AssertionError("the compiler folded the stream_ops chain")
    int_rate, why = int32_add_rate(sass)
    log(f"  INT32 add rate {int_rate:.6g}/s = {why}")

    log("phase 3: kernels against their plain versions")
    rows = kernel_checks(ops, ref)

    log("phase 4: granite-3-8b full width, 4 layers, f32: kernels vs plain")
    full_width_check(ops, ref)
    torch.cuda.empty_cache()
    log(f"phase 4: granite-3-8b, 40 layers, bf16, {BF16_PROMPT}-token prompt: "
        f"every attention call vs plain")
    full_width_bf16_check(ops, ref)
    torch.cuda.empty_cache()

    log("phase 5: main path: granite-3-8b, 40 layers, bf16, ServeEngine")
    kernels = ops.kernels()
    served = main_path(kernels)
    launches = served["launches"]
    torch.cuda.empty_cache()

    log("phase 6: streaming kernels at the paper's sizes, through ops")
    stream_rows, launches6 = streaming_kernels(ops, ref, kernels, int_rate)

    log("phase 7: the Fig. 2 entry point, repro_torch.benchmarks.run "
        "microbench")
    launches7 = microbench_entry_point(kernels)

    log("phase 8: PrIM bank-local kernels at PrIM's sizes, through ops")
    prim_rows, launches8 = prim_kernels(ops, ref, kernels, int_rate)
    torch.cuda.empty_cache()

    log(f"phase 9: the 16 PrIM workloads on the card, 1 bank at REF_N "
        f"(NW at {NW_CARD_N}), then {MULTIBANK} banks")
    launches9, _ = prim_workloads(kernels)
    int32_rows = int32_routes(ops, ref, int_rate)

    log("phase 10: the PrIM entry point, repro_torch.benchmarks.run "
        "prim_bench")
    launches10 = prim_entry_point(kernels)
    torch.cuda.empty_cache()

    log(f"phase 11: qwen2-moe-a2.7b full width, 2 layers, f32, "
        f"{MOE_PROMPT}-token prompt: kernels vs plain; the int8 route")
    moe_full_width_check(ops, ref)
    torch.cuda.empty_cache()
    log("phase 11: qwen2-moe-a2.7b, 24 layers, bf16 and int8 experts, "
        "ServeEngine")
    launches11, moe_decode_ms = moe_serve(kernels)
    torch.cuda.empty_cache()

    log("phase 12: sliding window: REDUCED starcoder2-7b and mixtral-8x7b "
        f"past the ring wrap; starcoder2-7b full width, {SWA_PROMPT}-token "
        "prompt")
    launches12 = window_checks(ops, ref, kernels)
    torch.cuda.empty_cache()

    log("phase 13: the suitability entry point, repro_torch.benchmarks.run "
        "suitability_bench; the census of the full-width decode steps")
    suitability_entry_point(kernels)
    decode_step_census("granite-3-8b", served["decode_ms_per_step"])
    decode_step_census("qwen2-moe-a2.7b", moe_decode_ms["bf16"])
    torch.cuda.empty_cache()

    log("phase 14: the planner-routed path: mixed_pipeline through "
        "runtime.execute; granite-3-8b through ServeEngine(engine="
        "'dispatch'); REDUCED mixtral-8x7b and starcoder2-7b")
    launches14 = {name: 0 for name in kernels}
    mixed_runtime(kernels, launches14)
    dispatch_f32_check(ops, ref, kernels, launches14)
    torch.cuda.empty_cache()
    dispatch_serve(ops, ref, kernels, launches14, served)
    torch.cuda.empty_cache()
    dispatch_reduced(kernels, launches14)
    log(f"  launches on the planner-routed path (phase 14): {launches14}")
    torch.cuda.empty_cache()

    log("phase 15: the serving gateway: granite-3-8b full width under "
        "Poisson arrivals; fused and dispatch gateways under one virtual "
        "clock; the gateway, dispatch and scaling bench entry points")
    launches15 = {name: 0 for name in kernels}
    t15 = time.perf_counter()
    gateway_full_width(kernels, served, launches15, smi)
    torch.cuda.empty_cache()
    gateway_pair(kernels, launches15)
    torch.cuda.empty_cache()
    gateway_entry_points(kernels, launches15)
    log(f"  launches on the gateway path (phase 15): {launches15}; phase "
        f"15 took {time.perf_counter() - t15:.1f}s")

    for name in ("va", "reduction", "gemv"):
        launches[name] = launches6[name]
    launches["stream_ops"] = launches7["stream_ops"]
    for name in (*prim_rows, "scan_lookback"):
        launches[name] = launches8[name]
    # the PrIM path's own count, beside (not added to) the phase above
    prim_path = {k: launches9[k] + launches10[k] for k in launches}
    log(f"  launches on the PrIM path (phases 9 and 10): {prim_path}")
    # the MoE and sliding-window runs' own count, beside phase 5's
    moe_swa = {k: launches11[k] + launches12[k] for k in launches}
    log(f"  launches on the MoE and sliding-window paths (phases 11 and "
        f"12): {moe_swa}")
    stream_rows.update(prim_rows)
    stream_rows["scan_lookback"] = int32_rows["ops.scan int32"]
    for name in ("decode_attention", "flash_attention"):
        # the bf16 row at the main path's first shape
        stream_rows[name] = next(r for r in rows[name]
                                 if r["dtype"] == "bfloat16" and "ms" in r)
    source = {"stream_ops": "microbench", "scan_blocks": "scan",
              "add_offsets": "scan", "scan_lookback": "scan",
              "ts_dists": "ts"}
    replaces = {"decode_attention": "src/repro/kernels/decode_attention.py:64",
                "flash_attention": "src/repro/kernels/flash_attention.py:79",
                "va": "src/repro/kernels/va.py:22",
                "reduction": "src/repro/kernels/reduction.py:28",
                "stream_ops": "src/repro/kernels/microbench.py:27",
                "gemv": "src/repro/kernels/gemv.py:32",
                "scan_blocks": "src/repro/kernels/scan_block.py:33",
                "add_offsets": "src/repro/kernels/scan_block.py:56",
                # the pair composed as repro.kernels.ops.scan
                "scan_lookback": "src/repro/kernels/scan_block.py:33",
                "histogram": "src/repro/kernels/histogram.py:36",
                "ts_dists": "src/repro/kernels/ts.py:30",
                "transpose": "src/repro/kernels/trns.py:21"}
    line = []
    for name in kernels:
        r = stream_rows[name]
        line.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{source.get(name, name)}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "prim_launches": prim_path[name],
            "moe_swa_launches": moe_swa[name],
            "dispatch_launches": launches14[name],
            "gateway_launches": launches15[name],
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
