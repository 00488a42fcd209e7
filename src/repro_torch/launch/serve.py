"""Serving launcher: batched continuous-batching decode over a model.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch rwkv6-3b --requests 8 --slots 4 --max-new 16

Every architecture of the zoo serves on the fused engine (rwkv6-3b,
jamba-1.5-large-398b, whisper-tiny and qwen2-vl-72b among them; whisper's
requests are token prompts, so its cross-attention reads the zero cross
cache, as in the reference). Weights are random, drawn from `--seed` on
the device. `--device` defaults to the card; `--device cpu --reduced`
runs the plain path.
`--engine dispatch` serves through the offload planner's plans
(`serve.dispatch_engine`: decode over the decode DAG, prefill chunked by
`--prefill-chunk` over the prefill DAG) instead of the fused forward.
`--profile` runs the workload under `torch.profiler` and prints the ops
that took the most device time and the device's busy share of the wall.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch
from torch.autograd import DeviceType

from ..configs import get_arch
from ..device import resolve_device
from ..models import init_params
from ..serve import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--engine", choices=("jit", "dispatch"), default="jit",
                    help="serving backend: the fused forward, or the "
                         "planner-routed dispatch steps for both prefill "
                         "and decode (dense and routed-MoE attention "
                         "decoders)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="dispatch engine: tokens per prefill chunk "
                         "(default: min(512, max_len))")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, reduced=args.reduced)
    dev = resolve_device(args.device)
    params = init_params(args.seed, cfg, dev)
    dispatch_kwargs = ({"prefill_chunk": args.prefill_chunk}
                       if args.engine == "dispatch" else None)
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         max_len=args.max_len, temperature=args.temperature,
                         seed=args.seed, device=dev, engine=args.engine,
                         dispatch_kwargs=dispatch_kwargs)
    if engine.dispatch_plan is not None:
        for what, p in (("decode", engine.dispatch_plan),
                        ("prefill", engine.prefill_plan)):
            devs = sorted(set(p.assignment.values()))
            print(f"{what} plan: {p.method}, {len(p.assignment)} stages "
                  f"on {devs}, modelled {p.total_s * 1e3:.3f} ms")
    gen = torch.Generator().manual_seed(args.seed + 1)
    reqs = []
    for i in range(args.requests):
        plen = 4 + int(torch.randint(0, 12, (), generator=gen))
        prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=gen,
                               dtype=torch.int32)
        reqs.append(Request(i, prompt, args.max_new))

    prof = _profiler(dev) if args.profile else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        done = engine.serve(reqs)
        dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"{len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s, continuous batching over "
          f"{args.slots} slots) on {name}")
    print(f"{engine.n_prefills} prefills in {engine.prefill_s:.3f}s, "
          f"{engine.n_decode_steps} decode steps in {engine.decode_s:.3f}s")
    if args.profile:
        key = ("self_device_time_total" if dev.type == "cuda"
               else "self_cpu_time_total")
        stats = prof.key_averages()
        print(stats.table(sort_by=key, row_limit=15))
        # kernels only: an op's row repeats the device time of its kernels
        busy = sum(e.self_device_time_total for e in stats
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation) / 1e6
        print(f"device busy {busy:.3f}s of {dt:.3f}s wall "
              f"({busy / dt:.1%}, under the profiler)")
    return 0


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


if __name__ == "__main__":
    raise SystemExit(main())
