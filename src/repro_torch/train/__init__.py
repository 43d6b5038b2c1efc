from .step import TrainConfig, TrainState, init_train_state, make_train_step

__all__ = ["TrainConfig", "TrainState", "init_train_state", "make_train_step"]
