from .step import (TrainState, cross_entropy, init_train_state,  # noqa: F401
                   loss_and_grads, make_loss_fn, make_train_step,
                   place_state)
