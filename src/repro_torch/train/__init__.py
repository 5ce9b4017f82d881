from repro_torch.train.optim import OptimizerConfig, build_optimizer
from repro_torch.train.trainer import Trainer, TrainState, make_train_step

__all__ = ["OptimizerConfig", "build_optimizer", "Trainer", "TrainState",
           "make_train_step"]
