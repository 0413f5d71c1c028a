"""Training on the card: the trainer, its optimizers and their states."""
from repro_torch.train.optimizer import (
    Optimizer, sgd, adagrad, adam, adamw, masked, apply_updates, clip_by_global_norm,
)
from repro_torch.train.trainer import Graph4RecTrainer, TrainerConfig, TrainResult
