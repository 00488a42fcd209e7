"""The port's examples (twins of the repository's `examples/`), each a
narrative command line:

    python -m repro_torch.examples.<name> [--device cpu]

  quickstart      a PrIM workload bank-parallel, its census and
                  suitability verdict, the Fig. 4 headline numbers
  prim_multibank  RED, SCAN-SSA and NW on an 8-bank grid
  dispatch_demo   plan -> schedule -> execute the mixed PrIM pipeline
  serve_decode    continuous-batching decode (fused or planner-routed)
  gateway_serve   the serving gateway under seeded Poisson arrivals

Each runs on the card unless `--device cpu` asks for the CPU. The
reference's `train_lm` comes with the port of `train/` (ROADMAP Queue 1,
item 18b).
"""
