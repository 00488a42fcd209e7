"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A run loads the cell's configuration and
traffic mix (`bench/configs`, `bench/workloads`), builds or loads the
port's kernels into `build/` inside the checkout, draws the weights on
the device from the seed, hands them to `repro_torch.serve.ServeEngine`,
warms the cell's shapes (an open loop: its shortest and longest prompt;
a closed loop: every client's request in progress, then two steps), and
measures for `--seconds`. With `--trace 1` a slice of the window, fixed
in the cell's file, runs under `torch.profiler`. Once the window has
closed and the peak memory is read, the engine's state is freed and a
sample of the finished requests is compared with the plain reference
(`bench.check`).

Standard output's last line is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number with its limit; standard error ends with
the same numbers. A run that finds no card, too few cards, or `jax`,
`jaxlib`, `flax` or `repro` among its modules after the window exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 60.0             # an open loop's requests may finish this late


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the configuration file `c`, the cell's
    mix `w`, the work counts, the device's peaks (None off the table),
    the window (host clock), every request served, the admissions and
    decode steps (host clock), the engine's counters over the window,
    the set-up seconds and the traced slice (None untraced)."""
    c: dict
    w: dict
    counts: object
    peaks: dict | None
    window: dict
    served: list
    prefills: list
    steps: list
    engine: dict
    setup_s: float
    slice: dict | None


def cache_dirs(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = root / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "CUDA_CACHE_PATH": str(build / "cuda_cache")}


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _counters(engine) -> dict:
    return {k: getattr(engine, k) for k in
            ("prefill_s", "n_prefills", "decode_s", "n_decode_steps")}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def chunks(served: list, window: dict, width: float = 10.0) -> list[int]:
    """Tokens known on the host in each `width` seconds of the window:
    whether a rate drifts within a run or only between runs."""
    n = max(1, math.ceil(window["seconds"] / width - 1e-9))
    out = [0] * n
    for r in served:
        for t in r.token_times:
            if window["t0"] <= t <= window["t1"]:
                out[min(n - 1, int((t - window["t0"]) / width))] += 1
    return out


def within(values: dict, limits: dict) -> bool:
    """Whether every compared number is at or under its limit."""
    return all(values[k] <= limits[k] for k in limits)


def run_cell(man, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             log=print, mix: dict | None = None, judge: bool = True,
             control: bool = False):
    """One run of cell `name` on `device`; returns the result line's
    object and the `Run` its metrics were read from. `device="cpu"` runs
    the program's plain path (tests); `mix` overrides keys of the cell's
    traffic file (the knee sweep's rates); `judge=False` skips the
    comparison; `control=True` also reads the control (`bench.control`)
    on the same sample, under the result's key "control"."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.serve import Request, ServeEngine

    from . import check, counts, driver, peaks, traffic, weights
    from .model import model_config
    from .trace import Slice

    t_start = T_START if t_start is None else t_start
    cell = man.cell(name)
    c = man.config(cell["config"])
    w = dict(man.workload(name), **(mix or {}))
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.BUILD_ROOT = man.root / "build" / "repro_torch_kernels"
        log(f"kernels ready in {_build.build_all():.2f} s "
            f"({_build.build_dir()})")
    cfg = model_config(c)
    tree = weights.make(c, seed, dev)
    engine = ServeEngine(cfg, tree, batch_slots=int(w["slots"]),
                         max_len=int(w["max_len"]), seed=int(seed) % 2**63,
                         device=dev)
    slice_ = None
    if trace:
        slice_ = Slice(w["trace"]["start_s"], w["trace"]["length_s"],
                       dev.type == "cuda")
    drv = driver.Driver(engine, Request, slice_)
    vocab = c["vocab_size"]

    # set-up: the cell's shapes, and a closed loop's steady state
    if w["loop"] == "open":
        specs = traffic.open_loop(w, seed, seconds, vocab)
        for i, n in enumerate((w["prompt_tokens"]["lo"],
                               w["prompt_tokens"]["hi"])):
            drv.admit(traffic.Spec(-1 - i, traffic.tokens(seed, 10**6 + i, n,
                                                          vocab), 3))
        drv.run_until_idle()
        drv.served.clear()
    elif w["loop"] == "closed":
        pool = traffic.ClosedLoop(w, seed, vocab)
        drv.fill(pool)
        for _ in range(2):
            for rec in drv.step():
                drv.follow(pool, rec)
    else:
        raise ValueError(f"loop {w['loop']!r}")
    if slice_ is not None:
        slice_.warm()
    drv.prefills.clear()
    drv.steps.clear()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = _counters(engine)
    setup_s = time.perf_counter() - t_start

    if w["loop"] == "open":
        window = drv.open_loop(specs, seconds, DRAIN_S)
        attempted = len(specs)
    else:
        window = drv.closed_loop(pool, seconds)
        # in flight when the window opened, or admitted in it
        attempted = sum(1 for r in drv.served if r.failed or
                        r.token_times[-1] >= window["t0"])
    if slice_ is not None:
        slice_.stop()
    _sync(dev)
    after = _counters(engine)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    sliced = slice_.read() if slice_ is not None else None
    failed = [r for r in drv.served if r.failed]
    lateness = sorted(r.admit_at - r.due_at for r in drv.served
                      if r.due_at is not None and r.admit_at is not None)
    log(f"tokens in each 10 s of the window: {chunks(drv.served, window)}")
    if lateness:
        log(f"generator lateness (admission start minus due) over "
            f"{len(lateness)} requests: median "
            f"{1e3 * lateness[len(lateness) // 2]:.3f} ms, max "
            f"{1e3 * lateness[-1]:.3f} ms")

    # the program's state goes before the reference runs
    drv.engine = None
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    chk = w["check"]
    done = [r for r in drv.served if r.done and r.failed is None]
    pick = check.sample(done, seed, int(chk["requests"])) if judge else []
    limits = {k: float(v) for k, v in chk["limit"].items()}
    values = dict.fromkeys(limits, math.inf)
    ref_s = 0.0
    if pick:
        g, ref_s = check.gaps(c, tree, pick)
        values = {k: check.NUMBERS[k](g) for k in limits}
    log(f"reference: {len(pick)} requests, "
        f"{sum(len(r.served) for r in pick)} served tokens, "
        f"{sum(r.prefilled for r in pick)} prompt tokens, {ref_s:.2f} s")
    correct = bool(pick) and not failed and within(values, limits)
    ctl = None
    if control and pick:
        # the control in the program's place, judged as the program is
        low, ctl_s = check.gaps(c, tree, pick, "fp8")
        numbers = {k: check.NUMBERS[k](low) for k in limits}
        ctl = {"correct": within(numbers, limits), "numbers": numbers,
               "seconds": ctl_s, "program_gaps": check.summary(g),
               "control_gaps": check.summary(low)}

    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    run = Run(c=c, w=w, counts=counts.Counts(c), peaks=peaks.peaks(kind),
              window=window, served=drv.served, prefills=drv.prefills,
              steps=drv.steps,
              engine={k: after[k] - before[k] for k in after},
              setup_s=setup_s, slice=sliced)
    metrics = {}
    for m in man.metrics(name, trace):
        v = man.reader(m["name"])(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": correct, "attempted": attempted, "failed": len(failed),
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": kind, "count": 1, "memory_peak_bytes": peak}}
    if sliced is not None:
        out["device"]["busy_s"] = sliced["busy_s"]
        out["device"]["window_s"] = sliced["window_s"]
        out["breakdown"] = sliced["breakdown"]
    if ctl is not None:
        out["control"] = ctl
    out["checks"] = {k: {"value": values[k], "limit": limits[k]}
                     for k in limits}
    log(f"weights {weights.nbytes(tree)} bytes, requests {attempted} "
        f"attempted, {len(failed)} failed, window {window['seconds']:.3f} s")
    return out, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    os.environ.update(cache_dirs(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from .manifest import Manifest
    man = Manifest(ROOT)
    chips = int(man.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"device: {_power_limit()}; torch {torch.__version__}")
    out, _ = run_cell(man, args.workload, args.seed, args.seconds,
                      bool(args.trace), log=log)
    bad = forbidden_modules()
    if bad:
        log(f"modules that no run may load were loaded: {bad}")
        return 3
    for name, chk in out["checks"].items():
        log(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
