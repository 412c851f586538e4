from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update)
from repro_torch.training.train import Trainer, loss_fn, make_train_step

__all__ = ["AdamWState", "adamw_init", "adamw_update", "Trainer", "loss_fn",
           "make_train_step"]
