from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_lr
from .train_step import TrainStepConfig, make_train_step, make_loss_fn
from .data import synthetic_lm_batch, copy_task_batch, make_batch_for

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
    "TrainStepConfig", "make_train_step", "make_loss_fn",
    "synthetic_lm_batch", "copy_task_batch", "make_batch_for",
]
