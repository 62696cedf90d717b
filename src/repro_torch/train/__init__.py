"""Training substrate: gradient accumulation (the paper's enabling
mechanism), AdamW, LR schedules, loss and the train step."""
from .grad_accum import accumulate_gradients
from .optimizer import (OptState, adamw_init, adamw_update, cosine_schedule,
                        wsd_schedule)
from .train_step import (TrainConfig, loss_fn, make_loss_and_grad,
                         make_train_step)

__all__ = ["OptState", "TrainConfig", "accumulate_gradients", "adamw_init",
           "adamw_update", "cosine_schedule", "loss_fn", "make_loss_and_grad",
           "make_train_step",
           "wsd_schedule"]
