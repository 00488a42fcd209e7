"""Serving example: continuous-batching decode — the paper's PIM pattern
applied to LM inference (DESIGN.md §4).

Runs a reduced model behind the ServeEngine: requests with skewed prompt
lengths share one batched KV cache (per-slot positions), new requests are
admitted as slots free up, and the decode step itself is the
bank-parallel workload (a batched GEMV against resident weights).

With `--engine dispatch` BOTH serving phases route through the offload
planner instead of one fused forward: decode over the decode DAG and
prefill chunked over the prefill DAG (`--prefill-chunk` tokens per
chunk), each planned over {xeon, upmem_2556} with the KV cache
bank-resident, and each stage runs on its assigned face (host stages as
plain calls, PIM stages as BankGrid phases) — same tokens,
planner-chosen execution. The prefill plan is optimized under the
schedule-aware `overlapped` objective (DESIGN.md §10).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        --engine dispatch --prefill-chunk 4 --show-schedule --device cpu

The twin of the repository's `examples/serve_decode.py`; prompts are
drawn from a CPU `torch.Generator`, so their tokens are not the
reference's.
"""

import argparse
import time

import torch

from ..configs import get_arch
from ..device import resolve_device
from ..models import init_params
from ..serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_decode")
    ap.add_argument("--arch", default="granite-3-8b",
                    help="any ported arch id (reduced config is used)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--engine", choices=("jit", "dispatch"), default="jit",
                    help="serving backend: fused steps, or planner-routed "
                         "hybrid dispatch for BOTH prefill and decode "
                         "(dense-attention archs only)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="dispatch engine: tokens per prefill chunk "
                         "(default: min(512, max_len))")
    ap.add_argument("--show-schedule", action="store_true",
                    help="dispatch engine: print the executed timeline — "
                         "the launch groups the executor walks, with "
                         "serial/overlapped/pipelined wall-clocks and "
                         "per-resource busy/idle occupancy")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record the measured execution trace (each "
                         "step's launch and sync seconds, the spans inside "
                         "it) and write it as JSON, plus a Chrome "
                         "trace_event twin next to it (.chrome.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch, reduced=True)
    print(f"arch: {cfg.name} ({cfg.param_count() / 1e6:.1f}M reduced) "
          f"on {device}")
    params = init_params(0, cfg, device)
    dispatch_kwargs = ({"prefill_chunk": args.prefill_chunk}
                       if args.engine == "dispatch" else None)
    engine = ServeEngine(cfg, params, batch_slots=args.slots, max_len=96,
                         temperature=args.temperature, seed=7,
                         device=device, engine=args.engine,
                         dispatch_kwargs=dispatch_kwargs)

    def show(tag, p):
        devs = {}
        for dev in p.assignment.values():
            devs[dev] = devs.get(dev, 0) + 1
        print(f"{tag} plan [{p.method}, objective={p.objective}]: "
              f"{len(p.assignment)} stages -> "
              + ", ".join(f"{d}:{n}" for d, n in sorted(devs.items()))
              + f"; modeled {p.total_s * 1e3:.2f}ms/step at serving dims")

    def show_schedule(tag, step):
        from ..dispatch.placement import evaluate
        from ..dispatch.schedule import make_schedule
        # cost the executor's OWN assignment (includes any forced
        # overrides), so the timeline shown is the timeline executed
        sched = make_schedule(
            step.dag, evaluate(step.dag, step.executor.assignment),
            pipelined=True)
        print(f"\n{tag} executed timeline (the launch groups the executor "
              "walks, in order):")
        print(sched.render(max_groups=8))
        groups = step.executor.executed_order()
        run = " -> ".join(f"{dev}:{len(nodes)}" for dev, nodes in groups[:10])
        more = f" -> ... (+{len(groups) - 10} groups)" if len(groups) > 10 \
            else ""
        print(f"  executed group order: {run}{more}")

    if engine.dispatch_plan is not None:
        show("decode", engine.dispatch_plan)
    if engine.prefill_plan is not None:
        show("prefill", engine.prefill_plan)
    if args.show_schedule and args.engine == "dispatch":
        show_schedule("decode", engine._dispatch_decode)
        show_schedule("prefill", engine._dispatch_prefill)

    tracer = None
    if args.trace:
        from ..dispatch.trace import Trace
        tracer = Trace(name=f"serve:{cfg.name}:{args.engine}")
        tracer.meta.update(arch=cfg.name, engine=args.engine,
                           slots=args.slots)
        if engine.dispatch_plan is not None:
            tracer.meta["assignment"] = dict(
                engine._dispatch_decode.executor.assignment)
        engine.attach_tracer(tracer)

    gen = torch.Generator().manual_seed(1)
    reqs = []
    for i in range(args.requests):
        plen = 4 + int(torch.randint(0, 12, (), generator=gen))
        reqs.append(Request(i, torch.randint(0, cfg.vocab_size, (plen,),
                                             generator=gen,
                                             dtype=torch.int32),
                            args.max_new))

    t0 = time.perf_counter()
    done = engine.serve(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid:2d} prompt[{len(r.prompt):2d}] "
              f"-> {len(r.out_tokens):2d} tokens: {r.out_tokens[:8]}...")
    print(f"\n{len(done)} requests, {n_tok} tokens, {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s, continuous batching over "
          f"{args.slots} slots)")

    if tracer is not None:
        chrome = (args.trace[:-5] if args.trace.endswith(".json")
                  else args.trace) + ".chrome.json"
        tracer.save(args.trace)
        tracer.save_chrome(chrome)
        steps = tracer.by_kind("decode_step")
        if steps:
            lat = sorted(e.dur_s for e in steps)
            launch = sum(e.attrs["launch_s"] for e in steps) / len(steps)
            sync = sum(e.attrs["sync_s"] for e in steps) / len(steps)
            print(f"trace: {len(tracer.events)} events "
                  f"({len(steps)} decode steps, median "
                  f"{lat[len(lat) // 2] * 1e3:.2f}ms/step, mean "
                  f"{launch * 1e3:.2f}ms launch + {sync * 1e3:.2f}ms sync; "
                  f"{len(tracer.by_kind('span'))} spans) "
                  f"-> {args.trace} (+ {chrome})")
    return done


if __name__ == "__main__":
    main()
