from repro_torch.train.loop import (chunked_cross_entropy, make_loss_fn,
                                    make_train_step, train_state_template)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "chunked_cross_entropy",
           "make_loss_fn", "make_train_step", "train_state_template"]
