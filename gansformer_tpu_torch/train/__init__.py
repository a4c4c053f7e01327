from gansformer_tpu_torch.train.state import (TrainState, create_train_state,
                                              derive_seed, lazy_adam)
from gansformer_tpu_torch.train.steps import (StepDraws, d_step, d_step_r1,
                                              draw_step, ema_beta_at,
                                              g_forward, g_step, g_step_pl,
                                              make_metric_samplers,
                                              pl_draws, pl_term, ppl_pairs,
                                              sample_images)

__all__ = ["StepDraws", "TrainState", "create_train_state", "d_step",
           "d_step_r1", "derive_seed", "draw_step", "ema_beta_at",
           "g_forward", "g_step", "g_step_pl", "lazy_adam",
           "make_metric_samplers", "pl_draws", "pl_term", "ppl_pairs",
           "sample_images"]
