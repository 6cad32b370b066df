"""Training: the step, the loop and checkpoints."""
from .checkpoint import restore_checkpoint, restore_params, save_checkpoint
from .step import (TrainState, bin_loss_weight, create_train_state,
                   make_default_objective, make_eval_step, make_lr_schedule,
                   make_train_step)

__all__ = ["TrainState", "bin_loss_weight", "create_train_state",
           "make_default_objective", "make_eval_step", "make_lr_schedule",
           "make_train_step", "restore_checkpoint", "restore_params",
           "save_checkpoint"]
