from gansformer_tpu_torch.losses.gan import (d_logistic_loss,
                                             g_nonsaturating_loss)

__all__ = ["d_logistic_loss", "g_nonsaturating_loss"]
