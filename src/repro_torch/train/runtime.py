"""Fault-tolerant training loop, the counterpart of `repro.train.runtime`:
checkpoint/restart, failure injection, straggler detection.

`TrainLoop.run()` drives steps with:
  * periodic atomic checkpoints (`checkpoint`) and resume from the latest,
  * exact restart: the data pipeline is a pure function of the step
    (`data`), and every op of the step gives the same bits on the same
    inputs, so a run that crashes and resumes ends bit-equal to one that
    does not,
  * a failure injector (`fail_at_step`) that stops the loop the way a
    preempted host would (after an optimizer update, before a checkpoint),
  * straggler detection: a step slower than `straggler_factor` x the
    running median is recorded and handed to `on_straggler`.

A step's time runs from the launch of its work to a host sync of its
loss. The parameters and moments are updated in place (`optimizer`).
With `shd` on a mesh the state and the batches are DTensors of
`step.train_shardings` and `Shardings.batch_spec`, and a resume restores
onto that mesh.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

from ..configs.shapes import ShapeConfig
from ..device import resolve_device
from ..models import ModelConfig, init_params
from . import checkpoint as ckpt_lib
from .data import DataConfig, make_batch
from .optimizer import HParams, adamw_init
from .step import make_train_step


class InjectedFailure(RuntimeError):
    """Stands in for a preemption or a host crash in tests."""


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_ckpts: int = 3
    log_every: int = 10
    fail_at_step: int | None = None       # failure injection (tests)
    straggler_factor: float = 3.0


@dataclasses.dataclass
class LoopState:
    params: Any
    opt: Any
    step: int


class TrainLoop:
    """The loop over `make_train_step(cfg, hp, shd=shd)` on `device` (None:
    the card), batches from `make_batch`."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, hp: HParams,
                 loop: LoopConfig, data: DataConfig = DataConfig(),
                 on_straggler: Callable[[int, float], None] | None = None,
                 device=None, shd=None):
        self.device = resolve_device(device)
        self.cfg, self.shape, self.shd = cfg, shape, shd
        self.hp, self.loop, self.data = hp, loop, data
        self.train_step = make_train_step(cfg, hp, shd=shd)
        self.metrics_log: list[dict] = []
        self.straggler_steps: list[int] = []
        self._durations: list[float] = []
        self.on_straggler = on_straggler

    # ---------------------------------------------------------------- #
    def init_state(self, seed: int = 0) -> LoopState:
        params = init_params(seed, self.cfg, self.device, self.shd)
        return LoopState(params, adamw_init(params, self.cfg), 0)

    def resume_or_init(self, seed: int = 0) -> LoopState:
        latest = ckpt_lib.latest_step(self.loop.ckpt_dir)
        state = self.init_state(seed)
        if latest is None:
            return state
        tree = ckpt_lib.restore(self.loop.ckpt_dir, latest,
                                {"params": state.params, "opt": state.opt})
        return LoopState(tree["params"], tree["opt"], latest)

    # ---------------------------------------------------------------- #
    def _check_straggler(self, step: int, dt: float):
        self._durations.append(dt)
        if len(self._durations) < 8:
            return
        recent = sorted(self._durations[-50:])
        med = recent[len(recent) // 2]
        if dt > self.loop.straggler_factor * med:
            self.straggler_steps.append(step)
            if self.on_straggler is not None:
                self.on_straggler(step, dt)

    def run(self, state: LoopState) -> LoopState:
        """Run to total_steps (raises InjectedFailure at fail_at_step)."""
        while state.step < self.loop.total_steps:
            step = state.step
            if self.loop.fail_at_step is not None and \
                    step == self.loop.fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            batch = make_batch(self.cfg, self.shape, step, self.data,
                               self.device, self.shd)
            t0 = time.perf_counter()
            params, opt, metrics = self.train_step(state.params, state.opt,
                                                   batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # host sync
            self._check_straggler(step, time.perf_counter() - t0)
            state = LoopState(params, opt, step + 1)
            if (step + 1) % self.loop.log_every == 0 or step == 0:
                self.metrics_log.append({"step": step + 1, **metrics})
            if (step + 1) % self.loop.ckpt_every == 0:
                ckpt_lib.save(self.loop.ckpt_dir, step + 1,
                              {"params": state.params, "opt": state.opt})
                ckpt_lib.prune(self.loop.ckpt_dir, self.loop.keep_ckpts)
        return state
