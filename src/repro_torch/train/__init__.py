"""Training on the card: the trainer, its optimizers and their states."""
from repro_torch.train.trainer import Graph4RecTrainer, TrainerConfig, TrainResult
