from gansformer_tpu_torch.train.state import (TrainState, create_train_state,
                                              derive_seed, lazy_adam)
from gansformer_tpu_torch.train.steps import (StepDraws, d_step, draw_step,
                                              ema_beta_at, g_forward, g_step)

__all__ = ["StepDraws", "TrainState", "create_train_state", "d_step",
           "derive_seed", "draw_step", "ema_beta_at", "g_forward", "g_step",
           "lazy_adam"]
