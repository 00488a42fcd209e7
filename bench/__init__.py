"""The benchmark of the PyTorch and CUDA port (`repro_torch`): serving
cells driven through `repro_torch.serve.ServeEngine`, their traffic,
metrics, work counts and plain reference. `python3 -m bench.run` runs one
cell (see `bench.run`)."""
