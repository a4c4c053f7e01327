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


def second_order_counts() -> Dict[str, int]:
    """Second-order passes since the last reset: the launches of the
    upfirdn kernel made as the adjoint's adjoint (also counted among the
    ``upfirdn`` launches), and the torch-op second-order passes of each
    attention direction, which launch no kernel."""
    return {"upfirdn_second_order": cuda_upfirdn.launches_second_order,
            "grid_to_latent_second_order": cuda_attention.second_order_g2l,
            "latent_to_grid_second_order": cuda_attention.second_order_l2g}


def path_launch_counts() -> Dict[str, int]:
    """Launches since the last reset of the routes of the kernels that
    have several: upfirdn (forward and adjoint) by route, grid->latent
    and latent->grid, forward and backward, by route."""
    ca = cuda_attention
    out = {f"upfirdn_{name}": cuda_upfirdn.path_launches[p]
           for p, name in cuda_upfirdn.PATH_NAMES.items()}
    out.update({f"grid_to_latent_{name}": ca.g2l_path_launches[p]
                for p, name in ca.G2L_NAMES.items()})
    out.update({f"grid_to_latent_bwd_{name}": ca.g2l_bwd_path_launches[p]
                for p, name in ca.G2L_NAMES.items()})
    out.update({f"latent_to_grid_{name}": ca.l2g_path_launches[p]
                for p, name in ca.L2G_NAMES.items()})
    out.update({f"latent_to_grid_bwd_{name}": ca.l2g_bwd_path_launches[p]
                for p, name in ca.L2G_NAMES.items()})
    return out


def reset_launch_counts() -> None:
    cuda_modconv.launches = 0
    cuda_modconv.launches_dx = 0
    cuda_modconv.launches_dw = 0
    cuda_upfirdn.launches = 0
    cuda_upfirdn.launches_adjoint = 0
    cuda_upfirdn.launches_second_order = 0
    cuda_attention.launches_g2l = 0
    cuda_attention.launches_l2g = 0
    cuda_attention.launches_g2l_bwd = 0
    cuda_attention.launches_l2g_bwd = 0
    cuda_attention.launches_g2l_lse = 0
    cuda_attention.launches_l2g_lse = 0
    cuda_attention.second_order_g2l = 0
    cuda_attention.second_order_l2g = 0
    for counts in (cuda_upfirdn.path_launches,
                   cuda_attention.g2l_path_launches,
                   cuda_attention.g2l_bwd_path_launches,
                   cuda_attention.l2g_path_launches,
                   cuda_attention.l2g_bwd_path_launches):
        for key in counts:
            counts[key] = 0


__all__ = ["ACTIVATIONS", "attention_plain", "conv2d", "downsample_2d",
           "filter_2d", "fused_bias_act", "fused_multihead_attention",
           "launch_counts", "lse_launch_counts", "modconv_plain",
           "modulated_conv2d", "multihead_attention", "path_launch_counts",
           "poly_w4", "reset_launch_counts", "second_order_counts",
           "setup_filter", "sinusoidal_grid_encoding", "upfirdn2d",
           "upfirdn2d_plain", "upsample_2d"]
