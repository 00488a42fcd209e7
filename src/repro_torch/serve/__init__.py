"""repro_torch.serve — the continuous-batching serving engine."""

from .engine import Request, ServeEngine, sample
