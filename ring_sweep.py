#!/usr/bin/env python3
"""The design sweep behind the ring kernels' constants, on one card.

    python3 ring_sweep.py            # from the repository root; one card

va and gemv stream through a ring of bulk copies (csrc/bulk_ring.cuh)
over a grid that their launchers size (`va.GRID_PER_SM`,
`gemv.BLOCKS_PER_SM`) with stages of a size fixed in the source (va's
kStageBytes) or by the launcher (`gemv.STAGE_CAP`). This script builds
copies of csrc/va.cu that differ only in kStageBytes, each also with its
stores of o as 16-byte st.global from registers in place of bulk stores,
and one that records every block's start and end (%globaltimer), into
build/ring_sweep/, holds every variant to the plain version, and then
times, by CUDA-graph replay (chip_smoke.graph_ms) in ROUNDS rounds of
turns:

- va on 2^27 int32 (PrIM VA): torch.add, the stride kernel, and the ring
  at each (stage size, ranges per SM) of VA_GRIDS, with each store;
- the spread of the blocks' end times of the ring at one block per SM;
- gemv at chip_smoke.GEMV_CASES: torch.mv, the rows kernel, and the ring
  at each (stage count, stage cap, blocks per SM) of GEMV_GRIDS (copies
  of csrc/gemv.cu that differ only in kRingStages).

Prints the median and every round of each, and writes them to
chiprun_out/ring_sweep.json. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs                                     # noqa: E402
from repro_torch.kernels import _build, ref                 # noqa: E402
from repro_torch.kernels import gemv as kgemv               # noqa: E402
from repro_torch.kernels import va as kva                   # noqa: E402

OUT = ROOT / "chiprun_out" / "ring_sweep.json"
BUILD = ROOT / "build" / "ring_sweep"
ROUNDS = 3
STAGE_LINE = "constexpr int kStageBytes = {};"
# (va's kStageBytes, ranges in the grid per SM)
VA_GRIDS = [(16384, 1), (16384, 4), (16384, 32), (8192, 1), (8192, 3),
            (8192, 16), (8192, 64), (8192, 128), (8192, 256), (4096, 128),
            (4096, 256)]
# (gemv's kRingStages, gemv.STAGE_CAP, blocks per SM)
GEMV_GRIDS = [(4, 32768, 1), (4, 32768, 2), (4, 16384, 1), (4, 16384, 2),
              (4, 16384, 3), (4, 16384, 8), (4, 8192, 1), (4, 8192, 3),
              (4, 8192, 16), (6, 16384, 1), (8, 8192, 1), (8, 16384, 1)]
GEMV_STAGES_LINE = "constexpr int kRingStages = {};"
# va's ring with o written by 16-byte st.global from registers
STG = ("""    uint4* buf = out_buf + (i & 1) * (kWarpBytes / 16);
    if (lane == 0) bulk_ring::store_wait_read<1>();   // buf's store of i - 2
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) buf[j * 32 + lane] = r[j];
    bulk_ring::fence_proxy_async();
    __syncwarp();
    if (lane == 0) bulk_ring::store(dst, buf, kWarpBytes);
""", """    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int j = 0; j < kLaneVecs; ++j) d4[j * 32 + lane] = r[j];
""")
STORES = ("bulk store", "st.global")
# va's ring with each block's start and end written to g_times
RANGE = ("  bulk_ring::block_range(blockIdx.x, per_block, extra, &first, "
         "&count);\n")
TIMER = "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));"
TIMED = [
    ("namespace {\n\nconstexpr int kThreads = 256;",
     "__device__ unsigned long long g_times[2 * 132 * 16];\n"
     "namespace {\n\nconstexpr int kThreads = 256;"),
    (RANGE, RANGE + "  if (threadIdx.x == 0) { unsigned long long t; " + TIMER
     + " g_times[2 * blockIdx.x] = t; }\n"),
    ("  if (lane == 0) bulk_ring::store_wait_all();\n",
     "  if (lane == 0) bulk_ring::store_wait_all();\n"
     "  if (threadIdx.x == 0) { unsigned long long t; " + TIMER
     + " g_times[2 * blockIdx.x + 1] = t; }\n"),
    ('extern "C" const char* error_string',
     'extern "C" int read_times(void* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_times, sizeof(g_times));\n}\n'
     'extern "C" const char* error_string'),
]


def build_variants() -> dict:
    """(stem, variant...) -> loaded library, all built at once."""
    shutil.rmtree(BUILD, ignore_errors=True)
    src = (_build.CSRC / "va.cu").read_text()
    here = STAGE_LINE.format(kva.STAGE_BYTES)
    if here not in src:
        raise RuntimeError(f"csrc/va.cu has no `{here}`")
    if STG[0] not in src:
        raise RuntimeError("csrc/va.cu changed: no bulk-store block")
    texts = {}
    for sb in sorted({sb for sb, _ in VA_GRIDS}):
        text = src.replace(here, STAGE_LINE.format(sb))
        texts[("va", sb, STORES[0])] = text
        texts[("va", sb, STORES[1])] = text.replace(*STG)
    timed = src.replace(here, STAGE_LINE.format(16384))
    for old, new in TIMED:
        if old not in timed:
            raise RuntimeError(f"csrc/va.cu changed: no {old!r}")
        timed = timed.replace(old, new)
    texts[("va", "timed", STORES[0])] = timed
    gsrc = (_build.CSRC / "gemv.cu").read_text()
    ghere = GEMV_STAGES_LINE.format(kgemv.STAGES)
    if ghere not in gsrc:
        raise RuntimeError(f"csrc/gemv.cu has no `{ghere}`")
    for st in sorted({st for st, _, _ in GEMV_GRIDS}):
        texts[("gemv", st, "")] = gsrc.replace(
            ghere, GEMV_STAGES_LINE.format(st))
    nvcc, jobs = _build.find_nvcc(), []
    for key, text in texts.items():
        stem = key[0]
        d = BUILD / "_".join(str(k).replace(" ", "-") for k in key)
        d.mkdir(parents=True)
        shutil.copy(_build.CSRC / "bulk_ring.cuh", d)
        (d / f"{stem}.cu").write_text(text)
        lib = d / f"lib{stem}.so"
        jobs.append((key, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(d / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


class Variant:
    """Point a kernel's wrapper at a variant library and launch plan."""

    def __init__(self, libs):
        self.libs = libs
        self.saved = {"va": (kva.STAGE_BYTES, kva.GRID_PER_SM),
                      "gemv": (kgemv.STAGES, kgemv.STAGE_CAP,
                               kgemv.BLOCKS_PER_SM)}

    def va(self, stage_bytes, per_sm, store=STORES[0], lib=None):
        kva.STAGE_BYTES, kva.GRID_PER_SM = stage_bytes, per_sm
        _build._LIBS["va"] = self.libs[("va", lib or stage_bytes, store)]
        kva.KERNEL._fn = None

    def gemv(self, stages, cap, per_sm):
        kgemv.STAGES, kgemv.STAGE_CAP, kgemv.BLOCKS_PER_SM = (stages, cap,
                                                              per_sm)
        _build._LIBS["gemv"] = self.libs[("gemv", stages, "")]
        kgemv.KERNEL._fn = None

    def restore(self):
        kva.STAGE_BYTES, kva.GRID_PER_SM = self.saved["va"]
        kgemv.STAGES, kgemv.STAGE_CAP, kgemv.BLOCKS_PER_SM = \
            self.saved["gemv"]
        for stem in ("va", "gemv"):
            _build._LIBS.pop(stem, None)
        kva.KERNEL._fn = kgemv.KERNEL._fn = None


def medians(times: dict) -> dict:
    return {k: {"median_ms": statistics.median(v), "rounds_ms": v}
            for k, v in times.items()}


def sweep_va(var, gen) -> dict:
    n = cs.PRIM_N
    sets = [tuple(torch.randint(0, 1 << 30, (n,), generator=gen,
                                device="cuda", dtype=torch.int32)
                  for _ in range(2)) for _ in range(2)]
    a, b = sets[0]
    want = ref.va(a, b)
    for sb, per_sm in VA_GRIDS:
        for store in STORES:
            var.va(sb, per_sm, store)
            if not torch.equal(kva.va(a, b), want):
                raise AssertionError(f"va {sb} B x {per_sm}/SM {store}: "
                                     f"not bit-exact")
    times = {}
    for _ in range(ROUNDS):
        times.setdefault("torch.add", []).append(cs.graph_ms(torch.add, sets))
        var.va(*VA_GRIDS[0])
        times.setdefault("stride", []).append(cs.graph_ms(
            lambda x, y: kva.va(x, y, "stride"), sets))
        for sb, per_sm in VA_GRIDS:
            for store in STORES:
                var.va(sb, per_sm, store)
                times.setdefault(
                    f"ring {sb // 1024} KB x {per_sm}/SM, {store}", []
                ).append(cs.graph_ms(kva.va, sets))
    # the blocks' end times at one block per SM, 16 KB stages
    var.va(16384, 1, lib="timed")
    lib = var.libs[("va", "timed", STORES[0])]
    spreads = []
    for _ in range(ROUNDS):
        got = kva.va(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("va timed variant: not bit-exact")
        buf = (ctypes.c_ulonglong * (2 * 132 * 16))()
        if lib.read_times(buf):
            raise RuntimeError("read_times failed")
        blocks = kva.plan_for(a, b, got, "ring").blocks
        t0 = min(buf[2 * i] for i in range(blocks))
        ends = sorted((buf[2 * i + 1] - t0) / 1e3 for i in range(blocks))
        spreads.append({"blocks": blocks, "first_end_us": ends[0],
                        "median_end_us": ends[blocks // 2],
                        "last_end_us": ends[-1],
                        "first_over_last": ends[0] / ends[-1]})
    return {"times": medians(times), "persistent_end_spread": spreads}


def sweep_gemv(var, gen) -> dict:
    times = {}
    for m, k, dt, what in cs.GEMV_CASES:
        sets = [((torch.randn(m, k, generator=gen, device="cuda") / 8).to(dt),
                 (torch.randn(k, generator=gen, device="cuda") / 8).to(dt))
                for _ in range(2 if m * k > 1e8 else 3)]
        A, x = sets[0]
        want = ref.gemv(A, x)
        for st, cap, per_sm in GEMV_GRIDS:
            var.gemv(st, cap, per_sm)
            cs.gemv_check(f"{what} {st} x {cap} B x {per_sm}/SM", A, x,
                          kgemv.gemv(A, x), want)
        for _ in range(ROUNDS):
            times.setdefault(f"{what}: torch.mv", []).append(
                cs.graph_ms(torch.mv, sets))
            times.setdefault(f"{what}: rows", []).append(cs.graph_ms(
                lambda A, x: kgemv.gemv(A, x, "rows"), sets))
            for st, cap, per_sm in GEMV_GRIDS:
                var.gemv(st, cap, per_sm)
                times.setdefault(
                    f"{what}: ring {st} x {cap // 1024} KB x {per_sm}/SM", []
                ).append(cs.graph_ms(kgemv.gemv, sets))
        del sets, A, x, want
        torch.cuda.empty_cache()
    return {"times": medians(times)}


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_sweep: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    var = Variant(build_variants())
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    try:
        result = {"device": smi, "va": sweep_va(var, gen),
                  "gemv": sweep_gemv(var, gen)}
    finally:
        var.restore()
    for kern in ("va", "gemv"):
        for name, t in result[kern]["times"].items():
            cs.log(f"  {kern} {name}: {t['median_ms']:.6g} ms "
                   f"{[round(r, 6) for r in t['rounds_ms']]}")
    for s in result["va"]["persistent_end_spread"]:
        cs.log(f"  va ring, one block per SM, 16 KB stages: {s['blocks']} "
               f"blocks end from {s['first_end_us']:.1f} us (median "
               f"{s['median_end_us']:.1f}) to {s['last_end_us']:.1f} us")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
