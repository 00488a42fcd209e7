"""Phase 5's serving path in two checkouts, measured in turns on one card.

    python3 serve_pair.py PARENT CHANGE

PARENT and CHANGE are directories that each hold a checkout of the
repository (for example `git archive <commit>` unpacked into an ignored
directory). In the order P C C P P C C P every letter starts one process
that imports that checkout's `repro_torch`, builds its kernels and serves
phase 5's workload (`chip_smoke.serve_workload` of the checkout this
script lives in, so that both sides serve the same requests) SERVES
times. Each process then times its `ops.decode_attention` and
`ops.flash_attention` (bf16 causal, bf16 with a 64-token window, f32
causal) at phase 3's first shapes by CUDA-graph replay (the card's time)
and the host time of one call of each bf16 kernel (what a call costs a
host-bound step). The first serve of a process is cold (allocator, cuBLAS
plans), the others warm. Prints, per checkout, the median and quartiles
of prefill ms per admission, decode ms/step and mean TTFT over the warm
serves, the kernel and host times, and in how many requests the first 8
greedy tokens agree; writes every reading to
chiprun_out/serve_pair.json. Needs one CUDA card; the processes run one
at a time.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ORDER = "PCCPPCCP"
SERVES = 5
OUT = HERE / "chiprun_out" / "serve_pair.json"

# runs in one process; TREE and HERE are prepended as assignments
CHILD = r'''
import json, sys, torch
sys.path.insert(0, TREE + "/src")
import repro_torch                  # that checkout's package from here on
sys.path.insert(0, HERE)
import chip_smoke as cs             # this checkout's workload and timers
from repro_torch.kernels import _build, ops

_build.build_all()
serves = []
for _ in range(SERVES):
    _, params, engine, reqs = cs.serve_workload()
    serves.append(cs.serve(engine, reqs)[1])
    del params, engine
    torch.cuda.empty_cache()

gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
b, h, kvh, hd, w, lengths = cs.DECODE_CASES[0]
dec = [(mk(b, h, hd), mk(b, w, kvh, hd), mk(b, w, kvh, hd)) for _ in range(4)]
lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
sq, skv, h, kvh, hd, _, _ = cs.FLASH_CASES[0]
fl = [(mk(1, sq, h, hd), mk(1, skv, kvh, hd), mk(1, skv, kvh, hd))
      for _ in range(4)]
fl32 = [tuple(t.float() for t in s) for s in fl]
calls = {
    "decode_attention": (lambda q, k, v: ops.decode_attention(q, k, v, lens),
                         dec),
    "flash_attention": (lambda q, k, v: ops.flash_attention(q, k, v, True, 0),
                        fl),
    "flash_attention_window64": (
        lambda q, k, v: ops.flash_attention(q, k, v, True, 64), fl),
    "flash_attention_f32": (
        lambda q, k, v: ops.flash_attention(q, k, v, True, 0), fl32),
}
kernel_ms = {n: cs.graph_ms(fn, sets) for n, (fn, sets) in calls.items()}
host = {n: cs.host_us(calls[n][0], calls[n][1][0])
        for n in ("decode_attention", "flash_attention")}
print("RESULT " + json.dumps({"serves": serves, "kernel_ms": kernel_ms,
                              "host_us": host}))
'''


def run_one(tree: Path) -> dict:
    code = f"TREE = {str(tree)!r}\nHERE = {str(HERE)!r}\nSERVES = {SERVES}\n"
    out = subprocess.run([sys.executable, "-c", code + CHILD], cwd=tree,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"serve run in {tree} failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def spread(xs: list[float]) -> str:
    """median (first quartile-third quartile)"""
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return f"{q2:.2f} ({q1:.2f}-{q3:.2f})"


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"P": Path(sys.argv[1]).resolve(), "C": Path(sys.argv[2]).resolve()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for i, tag in enumerate(ORDER):
        r = run_one(trees[tag])
        runs.append((tag, r))
        print(f"run {i} {tag}: " + "; ".join(
            f"prefill {s['prefill_ms']:.2f} ms/admission, decode "
            f"{s['decode_ms_per_step']:.2f} ms/step" for s in r["serves"])
            + "; kernels (ms) " + ", ".join(
                f"{k} {v:.5f}" for k, v in r["kernel_ms"].items()), flush=True)
    tokens = {}
    for tag, tree in trees.items():
        mine = [r for t, r in runs if t == tag]
        warm = [s for r in mine for s in r["serves"][1:]]
        tokens[tag] = mine[0]["serves"][0]["tokens"]
        print(f"{tag} ({tree}), warm serves (n={len(warm)}): prefill "
              f"ms/admission {spread([s['prefill_ms'] for s in warm])}, "
              f"decode ms/step "
              f"{spread([s['decode_ms_per_step'] for s in warm])}, mean TTFT "
              f"ms {spread([statistics.fmean(s['ttft_ms']) for s in warm])}")
        print("  kernels on the card (graph replay), microseconds: " + ", ".join(
            f"{k} {spread([r['kernel_ms'][k] * 1e3 for r in mine])}"
            for k in mine[0]["kernel_ms"]))
        print("  host time of one call, microseconds: " + ", ".join(
            f"{k} {spread([r['host_us'][k] for r in mine])}"
            for k in mine[0]["host_us"]))
    same = sum(a == b for a, b in zip(tokens["P"], tokens["C"]))
    print(f"first 8 greedy tokens identical in {same} of {len(tokens['P'])} "
          f"requests")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"device": smi, "order": ORDER,
                               "trees": {t: str(p) for t, p in trees.items()},
                               "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
