from .train import (
    EdmDraws,
    TrainState,
    edm_loss,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from .loop import train_loop
