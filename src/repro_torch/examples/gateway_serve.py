"""Serving-gateway example: admission control and SLO-aware scheduling
above the continuous-batching ServeEngine (DESIGN.md §14).

Generates a seeded Poisson arrival stream over three priority classes
(interactive / standard / batch), pushes it through the bounded
admission queue, and drives the engine with stall-budgeted prefill
interleaving. Decode and prefill admissions are priced through the
planner-product `PlanCache` (keyed by batch signature), so the gateway
knows the cost of a prefill stall before it takes one; `--prewarm`
solves the whole signature envelope out of band first, which is what
keeps in-band tails flat.

With `--engine dispatch` both phases route through the offload planner
(dense-attention archs only), and `--trace` records the measured
timeline the planner-fidelity gate can replay.

    PYTHONPATH=src python -m repro_torch.examples.gateway_serve [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.gateway_serve \
        --rate 16 --prewarm --device cpu
    PYTHONPATH=src python -m repro_torch.examples.gateway_serve \
        --engine dispatch --prefill-chunk 4 --requests 6 \
        --trace gw_trace.json --device cpu

The twin of the repository's `examples/gateway_serve.py`.
"""

import argparse

import torch

from ..configs import get_arch
from ..device import resolve_device
from ..models import init_params
from ..serve import (PRIORITIES, Gateway, Request, ServeEngine,
                     poisson_requests)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.gateway_serve")
    ap.add_argument("--arch", default="granite-3-8b",
                    help="any ported arch id (reduced config is used)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--queue-cap", type=int, default=8,
                    help="bounded admission-queue capacity")
    ap.add_argument("--policy", choices=("reject", "shed"), default="shed",
                    help="what to do when the queue is full: reject the "
                         "arrival, or shed the worst queued request for "
                         "a strictly higher-priority one")
    ap.add_argument("--engine", choices=("jit", "dispatch"), default="jit",
                    help="serving backend: fused steps, or planner-routed "
                         "hybrid dispatch for both phases")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="dispatch engine: tokens per prefill chunk")
    ap.add_argument("--prewarm", action="store_true",
                    help="price the full batch-signature envelope out of "
                         "band before serving (without it the first "
                         "occurrence of each signature pays its planner "
                         "solve in band)")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record the measured execution trace and write "
                         "it as JSON plus a Chrome trace_event twin "
                         "(.chrome.json)")
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
    engine = ServeEngine(cfg, params, batch_slots=args.slots, max_len=64,
                         device=device, engine=args.engine,
                         dispatch_kwargs=dispatch_kwargs)
    gw = Gateway(engine, queue_capacity=args.queue_cap,
                 shed_policy=args.policy, pos_bucket=16,
                 slo_ttft_s=0.5, slo_itl_s=0.25)

    prompt_lens = (4, 12)
    if args.prewarm:
        lens = range(prompt_lens[0], prompt_lens[1] + 1)
        warm = gw.prewarm(lens)
        print(f"prewarm: {warm['misses']} signature solves cached")
        if args.engine == "jit":
            # the fused engine's other in-band first-time cost is the
            # first call at each prefill shape (the kernels' build on the
            # card, the allocator's growth) — warm those too
            for i, plen in enumerate(lens):
                engine.serve([Request(-1 - i, torch.ones((plen,),
                                                         dtype=torch.int32),
                                      2)])
            print(f"prewarm: fused prefill run for lens "
                  f"{lens.start}..{lens.stop - 1}")

    tracer = None
    if args.trace:
        from ..dispatch.trace import Trace
        tracer = Trace(name=f"gateway:{cfg.name}:{args.engine}")
        tracer.meta.update(arch=cfg.name, engine=args.engine,
                           slots=args.slots, rate_rps=args.rate)
        gw.attach_tracer(tracer)

    reqs = poisson_requests(args.requests, args.rate, seed=args.seed,
                            vocab=cfg.vocab_size, prompt_lens=prompt_lens)
    stats = gw.run(reqs)

    for g in sorted(gw.finished, key=lambda g: g.rid):
        ttft = f"{g.ttft_s * 1e3:7.1f}" if g.ttft_s is not None else "      -"
        print(f"  req {g.rid:2d} [{PRIORITIES[g.priority]:11s}] "
              f"prompt[{len(g.prompt):2d}] -> {len(g.out_tokens):2d} tokens, "
              f"TTFT {ttft}ms")
    for g in sorted(gw.rejected, key=lambda g: g.rid):
        print(f"  req {g.rid:2d} [{PRIORITIES[g.priority]:11s}] "
              f"REJECTED ({g.reject_reason})")

    print()
    for metric, value in stats.rows():
        print(f"  {metric:22s} {value}")

    if tracer is not None:
        chrome = (args.trace[:-5] if args.trace.endswith(".json")
                  else args.trace) + ".chrome.json"
        tracer.save(args.trace)
        tracer.save_chrome(chrome)
        print(f"\ntrace: {len(tracer.events)} events -> {args.trace} "
              f"(+ {chrome})")
    return stats


if __name__ == "__main__":
    main()
