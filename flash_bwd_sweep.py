#!/usr/bin/env python3
"""The design sweep behind the flash backward's tensor-core tiling, on one card.

    python3 flash_bwd_sweep.py [OUT]     # from the repository root; one card

The tensor-core route of csrc/flash_attention_bwd.cu gives each warp 16
rows of its block (keys in the dK/dV kernel, queries in the dQ kernel)
and streams 64-row tiles of the other side; the warps a block
(kDkdvWarps, kDqWarps) set how many rows share each streamed tile, and
with the shared memory they take, how many blocks fit on an SM. This
script builds copies of the source that differ only in those two
constants (WARPS) into build/flash_bwd_sweep/, holds each variant's
gradients bit-equal to the shipped kernel's (each warp's sums run in the
same order whatever the block's size), and times every variant by
CUDA-graph replay (chip_smoke.graph_ms) in ROUNDS rounds of turns, at
granite-3-8b's training call and at whisper-tiny's encoder, with the
device time of each of its three launches (torch.profiler) beside it.

Prints the median and every round of each, and writes them as JSON to
OUT (default build/flash_bwd_sweep/flash_bwd_sweep.json). Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs                                         # noqa: E402
from repro_torch.kernels import _build                          # noqa: E402
from repro_torch.kernels import flash_attention as kfa          # noqa: E402
from repro_torch.kernels import flash_attention_bwd as kfb      # noqa: E402

BUILD = ROOT / "build" / "flash_bwd_sweep"
ROUNDS = 3
# (dK/dV warps, dQ warps): 64 or 128 rows a block
WARPS = [(4, 4), (8, 8), (8, 4), (4, 8)]
# (B, S, H, KVH, hd, causal, label): chip_smoke.BWD_CASES' timed shape and
# whisper-tiny's encoder
SHAPES = [(2, 4096, 32, 8, 128, True, "granite train_4k"),
          (4, 1500, 6, 6, 64, False, "whisper encoder")]


def build(dkdv: int, dq: int) -> ctypes.CDLL:
    """A copy of the backward's source with these warps a block, built
    with the port's flags."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for name, n in (("kDkdvWarps", dkdv), ("kDqWarps", dq)):
        src, found = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {n};", src)
        assert found == 1, name
    out = BUILD / f"w{dkdv}_{dq}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention_bwd.cu").write_text(src)
    lib = out / "libflash_attention_bwd.so"
    run = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(lib),
                          str(out / "flash_attention_bwd.cu")],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out}:\n{run.stdout}{run.stderr}")
    regs = [(label, r, s) for label, r, s, _ in
            cs.ptxas_per_kernel(run.stdout + run.stderr)
            if re.search(r"mma_kernel<(128|64),", label)]
    print(f"  built w{dkdv}_{dq} (kernel, registers, spill bytes): {regs}",
          flush=True)
    return ctypes.CDLL(str(lib))


def caller(lib: ctypes.CDLL):
    """The wrapper's launch of flash_attention_bwd, on this library."""
    fn = lib.flash_attention_bwd
    fn.argtypes, fn.restype = kfb.KERNEL.argtypes, ctypes.c_int

    def call(q, k, v, o, lse, do, causal):
        b, sq, h, hd = q.shape
        dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                      torch.empty_like(v))
        d = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), d.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], h,
                k.shape[2], hd, *strides, int(causal), 0, 1,
                kfb.ROUTES.index("tensor_core"),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention_bwd: CUDA error {rc}")
        return dq, dk, dv
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build_all()
    calls = {w: caller(build(*w)) for w in WARPS}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    result = {"device": smi, "rounds": ROUNDS, "shapes": []}
    for b, s, h, kvh, hd, causal, label in SHAPES:
        mk = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v, do = mk(b, s, h, hd), mk(b, s, kvh, hd), mk(b, s, kvh, hd), \
            mk(b, s, h, hd)
        o, lse = kfa.flash_attention(q, k, v, causal, return_lse=True)
        shipped = kfb.flash_attention_bwd(q, k, v, o, lse, do, causal)
        sets = [(q, k, v, o, lse, do)]
        row = {"shape": label, "variants": {}}
        for w, call in calls.items():
            got = call(q, k, v, o, lse, do, causal)
            if not all(torch.equal(a, c) for a, c in zip(got, shipped)):
                raise AssertionError(f"{label} w{w}: gradients differ from "
                                     f"the shipped kernel's")
        times = {w: [] for w in WARPS}
        for _ in range(ROUNDS):
            for w in [*WARPS, *reversed(WARPS)]:
                times[w].append(cs.graph_ms(
                    lambda *a, c=calls[w]: c(*a, causal), sets, reps=3,
                    per_rep=3))
        for w, call in calls.items():
            split = cs.kernel_device_ms(lambda *a: call(*a, causal), sets[0],
                                        "bwd_")
            row["variants"][f"dkdv {w[0]} warps, dq {w[1]} warps"] = {
                "ms": statistics.median(times[w]), "every": times[w],
                "kernel_ms": split}
            print(f"  {label}: dK/dV {w[0]} warps, dQ {w[1]} warps: "
                  f"{statistics.median(times[w]):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times[w])}); {split}",
                  flush=True)
        result["shapes"].append(row)
        del q, k, v, do, o, lse, shipped
        torch.cuda.empty_cache()
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        BUILD / "flash_bwd_sweep.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
