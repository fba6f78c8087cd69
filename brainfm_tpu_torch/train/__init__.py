from .checkpoint import (finalize_pending, latest_checkpoint, load_checkpoint,
                         read_extra, save_best_checkpoint, save_checkpoint,
                         step_from_path)
from .loop import (apply_condition, make_batch, make_eval_step, make_val_set,
                   train)
from .schedules import build_schedules, cosine_schedule, multistep_schedule
from .step import (LARS, TrainState, build_optimizer, clip_by_global_norm,
                   clip_per_parameter, make_train_step)

__all__ = ["finalize_pending", "latest_checkpoint", "load_checkpoint",
           "read_extra", "save_best_checkpoint", "save_checkpoint",
           "step_from_path", "apply_condition", "make_batch",
           "make_eval_step", "make_val_set", "train", "build_schedules",
           "cosine_schedule", "multistep_schedule", "LARS", "TrainState",
           "build_optimizer", "clip_by_global_norm", "clip_per_parameter",
           "make_train_step"]
