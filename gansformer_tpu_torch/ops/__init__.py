"""Ops of the PyTorch port: plain PyTorch versions plus the hand-written
CUDA kernels they route to for tensors on the card (forward: modconv,
upfirdn, grid->latent, latent->grid; backward: modconv dx/ds, modconv
dw, the upfirdn adjoint, grid->latent and latent->grid)."""

from typing import Dict

from gansformer_tpu_torch.ops import cuda_attention, cuda_modconv, \
    cuda_upfirdn
from gansformer_tpu_torch.ops.attention import (attention_plain,
                                                multihead_attention,
                                                sinusoidal_grid_encoding)
from gansformer_tpu_torch.ops.cuda_attention import fused_multihead_attention
from gansformer_tpu_torch.ops.fused_bias_act import (ACTIVATIONS,
                                                     fused_bias_act)
from gansformer_tpu_torch.ops.modulated_conv import (conv2d, modconv_plain,
                                                     modulated_conv2d,
                                                     poly_w4)
from gansformer_tpu_torch.ops.upfirdn2d import (downsample_2d, filter_2d,
                                                setup_filter, upfirdn2d,
                                                upfirdn2d_plain, upsample_2d)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {"modconv": cuda_modconv.launches,
            "upfirdn": cuda_upfirdn.launches,
            "grid_to_latent": cuda_attention.launches_g2l,
            "latent_to_grid": cuda_attention.launches_l2g,
            "modconv_dx": cuda_modconv.launches_dx,
            "modconv_dw": cuda_modconv.launches_dw,
            "upfirdn_adjoint": cuda_upfirdn.launches_adjoint,
            "grid_to_latent_bwd": cuda_attention.launches_g2l_bwd,
            "latent_to_grid_bwd": cuda_attention.launches_l2g_bwd}


def lse_launch_counts() -> Dict[str, int]:
    """Of the forward attention launches since the last reset, those that
    wrote the ``lse`` statistic (a graph was wanted)."""
    return {"grid_to_latent": cuda_attention.launches_g2l_lse,
            "latent_to_grid": cuda_attention.launches_l2g_lse}


def reset_launch_counts() -> None:
    cuda_modconv.launches = 0
    cuda_modconv.launches_dx = 0
    cuda_modconv.launches_dw = 0
    cuda_upfirdn.launches = 0
    cuda_upfirdn.launches_adjoint = 0
    cuda_attention.launches_g2l = 0
    cuda_attention.launches_l2g = 0
    cuda_attention.launches_g2l_bwd = 0
    cuda_attention.launches_l2g_bwd = 0
    cuda_attention.launches_g2l_lse = 0
    cuda_attention.launches_l2g_lse = 0


__all__ = ["ACTIVATIONS", "attention_plain", "conv2d", "downsample_2d",
           "filter_2d", "fused_bias_act", "fused_multihead_attention",
           "launch_counts", "lse_launch_counts", "modconv_plain",
           "modulated_conv2d", "multihead_attention", "poly_w4",
           "reset_launch_counts", "setup_filter", "sinusoidal_grid_encoding",
           "upfirdn2d", "upfirdn2d_plain", "upsample_2d"]
