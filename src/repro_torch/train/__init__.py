"""Training: the loss's optimizer (AdamW, 8-bit AdamW) and the train step."""
from .optimizer import OptConfig, init_state, apply_updates, lr_schedule, global_norm
from .train_step import make_train_step, make_eval_step

__all__ = ["OptConfig", "init_state", "apply_updates", "lr_schedule", "global_norm", "make_train_step", "make_eval_step"]
