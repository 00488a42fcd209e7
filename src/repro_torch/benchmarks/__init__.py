"""The port's benchmark modules (twins of the repository's `benchmarks/`),
run through `python -m repro_torch.benchmarks.run`."""
