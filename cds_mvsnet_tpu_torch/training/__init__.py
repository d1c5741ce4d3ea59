"""Training: the loss, the train step, validation metrics and the Trainer."""

from .train_step import TrainStep, learning_rate, temperature_schedule
from .trainer import Trainer

__all__ = ["TrainStep", "Trainer", "learning_rate", "temperature_schedule"]
