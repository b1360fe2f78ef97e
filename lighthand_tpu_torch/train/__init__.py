from lighthand_tpu_torch.train.state import (
    TrainState,
    cosine_lr,
    create_train_state,
    set_learning_rate,
)
from lighthand_tpu_torch.train.step import (
    make_eval_step,
    make_fused_train_step,
    make_predict_step,
    make_targets,
    make_train_step,
)

__all__ = [
    "TrainState",
    "cosine_lr",
    "create_train_state",
    "set_learning_rate",
    "make_eval_step",
    "make_fused_train_step",
    "make_predict_step",
    "make_targets",
    "make_train_step",
]
