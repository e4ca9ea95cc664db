from .loop import StepTimer, TrainConfig, make_train_step, train_loop
from .optimizer import (AdamWConfig, adamw_update, init_opt_state,
                        opt_logical_axes)
from .state import init_state, state_logical_axes
