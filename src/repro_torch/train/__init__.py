from .loop import StepTimer, TrainConfig, make_train_step, train_loop
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .state import init_state
