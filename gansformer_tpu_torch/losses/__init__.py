from gansformer_tpu_torch.losses.gan import (d_logistic_loss,
                                             g_nonsaturating_loss,
                                             r1_penalty, r1_slice)

__all__ = ["d_logistic_loss", "g_nonsaturating_loss", "r1_penalty",
           "r1_slice"]
