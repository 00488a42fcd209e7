"""repro_torch.train — optimizer, data, checkpointing and the
fault-tolerant loop, the counterpart of `repro.train`."""

from .checkpoint import latest_step, prune, restore, save, valid_steps
from .data import DataConfig, make_batch
from .optimizer import (HParams, adamw_init, adamw_update,
                        clip_by_global_norm, global_norm, opt_specs,
                        schedule)
from .runtime import InjectedFailure, LoopConfig, LoopState, TrainLoop
from .step import loss_fn, make_eval_step, make_train_step, train_shardings
