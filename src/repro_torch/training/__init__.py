from repro_torch.training.optimizer import (AdamWConfig, adamw_update,  # noqa: F401
                                            init_moments, schedule)
from repro_torch.training.step import (TrainState, init_state,  # noqa: F401
                                       make_eval_step, make_train_step)
